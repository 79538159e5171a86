"""In-memory, tiered object store with spilling.

Port of `ray_tpu/core/object_store.py` for one process. Tiers:

- INLINE and HOST: host values (Python objects, numpy arrays, CPU
  tensors), INLINE up to ``cfg.inline_max_bytes`` and HOST above it. Only
  HOST objects spill: LRU over sealed HOST entries once the host
  bytes pass the capacity, pickled to ``spill_dir`` and restored on the
  next get (a CPU tensor restores bit for bit); without a spill dir a
  victim drops to LOST and lineage re-executes its task on the next get.
- DEVICE: a CUDA tensor. The JAX package keeps `jax.Array` handles here;
  the port keeps the tensor itself, counted in ``device_bytes`` and never
  copied to the host: `get` returns the same tensor (the same
  `data_ptr`). The card's memory is the caching allocator's to manage:
  the store tracks device bytes but never allocates or frees them itself;
  the tensor's memory returns to the allocator when the last ref and the
  last user reference drop.

Streams: the store neither copies nor synchronises a DEVICE value. Work
queued on a tensor before `put` and work queued on it after `get` are
ordered only if both are on the same CUDA stream; every thread uses the
device's default stream unless it selects another, so that is the stream
the store assumes. A producer that writes on a side stream records an
event after the write and the consumer waits on it (as
`data/lm.py`'s feed does).

Handles are refcounted (`ObjectRef` increfs, its `__del__` decrefs): at
zero handles the value is released and an entry with recorded lineage
drops to LOST, to be re-executed if a ref comes back. A pin (`pin` /
`unpin`, counted in `pin_count`) holds a sealed value against that
release and against spilling; `free` drops an object at once. The JAX
package's shared-memory arena tier (`native_store.py`) and its REMOTE
tier (a value in another node's store, borrowed references) come with
multi-process workers and clusters.
"""

from __future__ import annotations

import enum
import os
import pickle
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch

from .exceptions import GetTimeoutError, ObjectLostError
from .ids import ObjectID


class Tier(enum.Enum):
    INLINE = "inline"      # small host objects, kept as-is in process
    HOST = "host"          # large host objects (numpy, CPU tensors), spillable
    DEVICE = "device"      # CUDA tensors, kept on the card, never spilled
    SPILLED = "spilled"    # on disk


def _estimate_nbytes(value: Any) -> int:
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, str):
        return len(value)
    # Cheap structural estimate; exact size does not matter for eviction
    # decisions, only relative magnitude.
    if isinstance(value, (list, tuple)):
        return 64 + sum(_estimate_nbytes(v) for v in value[:100]) * max(1, len(value) // max(1, min(len(value), 100)))
    if isinstance(value, dict):
        items = list(value.items())[:100]
        per = sum(_estimate_nbytes(k) + _estimate_nbytes(v) for k, v in items)
        return 64 + per * max(1, len(value) // max(1, min(len(value), 100)))
    return 64


def _is_device_array(value: Any) -> bool:
    return isinstance(value, torch.Tensor) and value.is_cuda


class ObjectState(enum.Enum):
    PENDING = "pending"   # task not finished yet
    READY = "ready"
    ERROR = "error"       # creating task raised
    LOST = "lost"         # evicted without spill, or released by GC


class ObjectEntry:
    __slots__ = (
        "object_id", "state", "value", "error", "tier", "nbytes",
        "pin_count", "event", "callbacks", "spill_path", "owner_task",
        "last_access", "lock", "handle_count", "gc_on_seal", "gc_done",
    )

    def __init__(self, object_id: ObjectID):
        self.object_id = object_id
        self.state = ObjectState.PENDING
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.tier = Tier.INLINE
        self.nbytes = 0
        # pins hold a sealed value against GC and spilling (`pin` / `unpin`)
        self.pin_count = 0
        self.event = threading.Event()
        self.callbacks: List[Callable[["ObjectEntry"], None]] = []
        self.spill_path: Optional[str] = None
        # TaskSpec of the creating task, for lineage reconstruction.
        self.owner_task = None
        self.last_access = time.monotonic()
        # RLock: _restore (under this lock, via get) may trigger _maybe_spill
        # which revisits the same entry.
        self.lock = threading.RLock()
        # Live ObjectRef handles. 0 handles + sealed → value is GC-eligible.
        self.handle_count = 0
        self.gc_on_seal = False
        # One-shot latch: the value was released by GC. Two racing
        # last-releasers must not double-run the accounting in
        # _release_value.
        self.gc_done = False


class ObjectStore:
    """Thread-safe object table with futures semantics and LRU spilling."""

    def __init__(self, capacity_bytes: int = 8 << 30, spill_dir: Optional[str] = None):
        from .config import cfg

        self._entries: "OrderedDict[ObjectID, ObjectEntry]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.RLock()
        self._capacity = capacity_bytes
        self._inline_max = cfg.inline_max_bytes
        self._host_bytes = 0
        self._device_bytes = 0
        self._spill_dir = spill_dir
        self.stats = {
            "puts": 0, "gets": 0, "spills": 0, "restores": 0, "evictions": 0,
            "reconstructions": 0, "gc": 0, "spilled_bytes": 0, "restored_bytes": 0,
        }
        # Lineage resubmission hook (Runtime wires scheduler.submit here):
        # get() of a LOST entry with a recorded owner_task re-executes it.
        self._resubmit: Optional[Callable[[Any], None]] = None
        self._reconstruct_lock = threading.Lock()
        self.max_reconstructions = 3

    def set_resubmit(self, fn: Callable[[Any], None]) -> None:
        self._resubmit = fn

    # ------------------------------------------------------------------ write

    def create(self, object_id: ObjectID, owner_task=None) -> ObjectEntry:
        """Register a pending object (a task return slot)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = ObjectEntry(object_id)
                self._entries[object_id] = entry
            if owner_task is not None:
                entry.owner_task = owner_task
            return entry

    def put(self, object_id: ObjectID, value: Any, owner_task=None) -> ObjectEntry:
        """Seal a value into the store (create + fulfill in one step)."""
        entry = self.create(object_id, owner_task=owner_task)
        self.seal(object_id, value)
        return entry

    def seal(self, object_id: ObjectID, value: Any) -> None:
        nbytes = _estimate_nbytes(value)
        with self._lock:
            entry = self._entries[object_id]
        # entry.lock BEFORE the store lock (the established order): the
        # re-seal path below releases the old READY value, and a concurrent
        # get() holding entry.lock mid-_restore must never have spill_path
        # unlinked or value cleared under it.
        with entry.lock, self._lock:
            if entry.state == ObjectState.READY:
                # Re-seal: a lineage reconstruction raced the original
                # execution and both sealed. Replace, releasing the old
                # value's accounting so bytes don't double-count.
                self._release_value(entry)
            if _is_device_array(value):
                tier = Tier.DEVICE
                self._device_bytes += nbytes
            elif nbytes <= self._inline_max:
                tier = Tier.INLINE
                self._host_bytes += nbytes
            else:
                tier = Tier.HOST
                self._host_bytes += nbytes
            entry.value = value
            entry.nbytes = nbytes
            entry.tier = tier
            entry.state = ObjectState.READY
            entry.gc_done = False  # a re-seal makes the entry collectable again
            entry.last_access = time.monotonic()
            callbacks = list(entry.callbacks)
            entry.callbacks.clear()
        self.stats["puts"] += 1
        entry.event.set()
        for cb in callbacks:
            cb(entry)
        if entry.gc_on_seal:
            # every handle died while the task was still running
            entry.gc_on_seal = False
            self._gc_entry(entry)
        # Spill/evict outside the store lock: disk I/O must not block
        # unrelated puts/gets.
        self._maybe_spill()

    def seal_error(self, object_id: ObjectID, error: BaseException) -> None:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = self.create(object_id)
            entry.error = error
            entry.state = ObjectState.ERROR
            callbacks = list(entry.callbacks)
            entry.callbacks.clear()
        entry.event.set()
        for cb in callbacks:
            cb(entry)
        if entry.gc_on_seal:
            entry.gc_on_seal = False
            self._gc_entry(entry)

    # ------------------------------------------------------------------- read

    def entry(self, object_id: ObjectID) -> Optional[ObjectEntry]:
        with self._lock:
            return self._entries.get(object_id)

    def is_ready(self, object_id: ObjectID) -> bool:
        entry = self.entry(object_id)
        return entry is not None and entry.event.is_set()

    def add_ready_callback(self, object_id: ObjectID, cb: Callable[[ObjectEntry], None]) -> None:
        """Invoke cb(entry) once the object is sealed (or errored).

        Runs immediately (in the calling thread) if already sealed. This is
        the scheduler's dependency-resolution hook.
        """
        run_now = False
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = self.create(object_id)
            if entry.event.is_set():
                run_now = True
            else:
                entry.callbacks.append(cb)
        if run_now:
            cb(entry)

    def remove_ready_callback(self, object_id: ObjectID, cb: Callable[[ObjectEntry], None]) -> None:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and cb in entry.callbacks:
                entry.callbacks.remove(cb)

    def get(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = self.create(object_id)
        deadline = None if timeout is None else time.monotonic() + timeout
        reconstructions = 0
        restored = False
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if not entry.event.wait(remaining):
                raise GetTimeoutError(
                    f"Get timed out after {timeout}s waiting for {object_id}"
                )
            # Everything below re-validates under entry.lock: between the
            # wait and here, a reconstruction may have flipped the entry
            # back to PENDING (clearing the event), or eviction may have
            # flipped READY→LOST. Act only on the state actually held.
            done = False
            with entry.lock:
                state = entry.state
                if state == ObjectState.ERROR:
                    self.stats["gets"] += 1
                    raise entry.error
                if state == ObjectState.READY:
                    entry.last_access = time.monotonic()
                    if entry.tier == Tier.SPILLED:
                        value = self._restore(entry)
                        restored = True
                    else:
                        value = entry.value
                    done = True
            if done:
                break
            if state == ObjectState.LOST:
                # Lineage reconstruction: re-execute the recorded creating
                # task and wait again. Bounded so a deterministic failure
                # cannot loop.
                if (
                    reconstructions < self.max_reconstructions
                    and self._try_reconstruct(entry)
                ):
                    reconstructions += 1
                    continue
                raise ObjectLostError(object_id)
            # PENDING again (a reconstruction won the race): just re-wait.
        self.stats["gets"] += 1
        if restored:
            # Outside entry.lock: spilling victims takes *their* entry locks,
            # and holding one entry lock while waiting on another is an ABBA
            # deadlock between two concurrent restores.
            self._maybe_spill()
        return value

    def _try_reconstruct(self, entry: ObjectEntry) -> bool:
        """Flip a LOST entry (and its sibling returns) back to PENDING and
        resubmit the creating task. Exactly one caller wins the flip; losers
        just re-wait. False if there is no lineage to replay."""
        spec = entry.owner_task
        if spec is None or self._resubmit is None:
            return False
        # One flat lock for the flip phase: two getters reconstructing
        # different returns of the same task would otherwise take sibling
        # entry locks in opposite orders (ABBA deadlock).
        with self._reconstruct_lock:
            with entry.lock:
                if entry.state != ObjectState.LOST:
                    return True  # another getter already reconstructed
            for oid in spec.return_ids:
                sibling = self.entry(oid)
                if sibling is None:
                    continue
                with sibling.lock:
                    # a sibling still READY/SPILLED must release its value
                    # (bytes, spill file) before re-execution overwrites it
                    self._release_value(sibling)
                    sibling.state = ObjectState.PENDING
                    sibling.error = None
                    sibling.tier = Tier.INLINE
                    sibling.event.clear()
        spec.attempt = 0
        self.stats["reconstructions"] += 1
        self._resubmit(spec)
        return True

    # ---------------------------------------------------------- handle counts

    def incref(self, object_id: ObjectID) -> None:
        """A new ObjectRef handle exists for this object."""
        while True:
            with self._lock:
                entry = self._entries.get(object_id)
                if entry is None:
                    # Only a re-bound handle (unpickled after the entry was
                    # fully GC'd) increfs a missing id. There is no producer,
                    # so surface the loss instead of leaving a PENDING entry
                    # nothing will ever seal (get() would hang forever).
                    entry = self.create(object_id)
                    entry.state = ObjectState.LOST
                    entry.event.set()
            with entry.lock:
                entry.handle_count += 1
                if entry.handle_count > 1:
                    return  # entry demonstrably live; no pop race possible
                # First handle back: a concurrent no-lineage GC may have
                # popped this entry between our lookup and taking entry.lock.
                # Re-check the table: if our entry still owns the slot we are
                # done; if the slot is empty, re-insert it as LOST; if a
                # NEWER entry took the slot, undo our count on the stale
                # entry and retry against it.
                with self._lock:
                    current = self._entries.get(object_id)
                    if current is entry:
                        return
                    if current is None:
                        entry.state = ObjectState.LOST
                        entry.value = None
                        entry.event.set()
                        self._entries[object_id] = entry
                        return
                    entry.handle_count -= 1
            # loop: incref the entry that actually owns the slot now

    def decref(self, object_id: ObjectID) -> None:
        """An ObjectRef handle died. At zero handles the VALUE is released:
        the entry drops to LOST but keeps its owner_task, so a ref that
        comes back can still reconstruct via lineage. Entries with no
        lineage are removed."""
        entry = self.entry(object_id)
        if entry is None:
            return
        gc_now = False
        with entry.lock:
            entry.handle_count = max(0, entry.handle_count - 1)
            if entry.handle_count == 0:
                if entry.event.is_set():
                    gc_now = True
                else:
                    entry.gc_on_seal = True
        if gc_now:
            self._gc_entry(entry)

    def _gc_entry(self, entry: ObjectEntry) -> None:
        with entry.lock:
            if entry.handle_count > 0 or entry.pin_count > 0:
                return  # a handle was recreated (incref) since the decref
            if entry.gc_done:
                return  # a concurrent last-releaser already ran
            entry.gc_done = True
            self._release_value(entry)
            self.stats["gc"] += 1
            if entry.owner_task is not None:
                entry.state = ObjectState.LOST  # reconstructable via lineage
                entry.tier = Tier.INLINE
                return
            # No lineage: drop the entry while STILL holding entry.lock so
            # the liveness check and the pop are atomic with respect to a
            # concurrent incref.
            with self._lock:
                self._entries.pop(entry.object_id, None)

    def pin(self, object_id: ObjectID) -> None:
        entry = self.entry(object_id)
        if entry is not None:
            with entry.lock:
                entry.pin_count += 1

    def unpin(self, object_id: ObjectID) -> None:
        entry = self.entry(object_id)
        if entry is not None:
            with entry.lock:
                entry.pin_count = max(0, entry.pin_count - 1)

    def _release_value(self, entry: ObjectEntry) -> None:
        """Drop a READY entry's stored value and every resource behind it
        (byte accounting, spill file). Caller synchronizes (entry.lock, or
        the store lock on the seal path — the store lock is re-entrant, so
        the internal counter updates are safe)."""
        if entry.state == ObjectState.READY:
            if entry.tier == Tier.DEVICE:
                with self._lock:
                    self._device_bytes -= entry.nbytes
            elif entry.tier in (Tier.INLINE, Tier.HOST):
                with self._lock:
                    self._host_bytes -= entry.nbytes
        if entry.spill_path and os.path.exists(entry.spill_path):
            os.unlink(entry.spill_path)
        entry.spill_path = None
        entry.value = None

    def free(self, object_id: ObjectID) -> None:
        """Drop an object now, whatever its handles and pins: its value
        and accounting are released and the entry leaves the table."""
        with self._lock:
            entry = self._entries.pop(object_id, None)
        if entry is not None:
            with entry.lock:
                if not entry.gc_done:  # a racing GC may have released it
                    entry.gc_done = True
                    self._release_value(entry)

    # -------------------------------------------------------------- spill/LRU

    def _maybe_spill(self) -> None:
        with self._lock:
            if self._host_bytes <= self._capacity:
                return
            # LRU over unpinned host-tier entries (victim selection only;
            # the I/O happens per-entry outside the store lock).
            candidates = sorted(
                (e for e in self._entries.values()
                 if e.state == ObjectState.READY and e.tier == Tier.HOST
                 and e.pin_count == 0),
                key=lambda e: e.last_access,
            )
        for entry in candidates:
            with self._lock:
                if self._host_bytes <= self._capacity:
                    break
            with entry.lock:
                if entry.tier != Tier.HOST or entry.pin_count > 0:
                    continue
                if self._spill_dir is not None:
                    self._spill(entry)
                else:
                    entry.value = None
                    entry.state = ObjectState.LOST
                    with self._lock:
                        self._host_bytes -= entry.nbytes
                    self.stats["evictions"] += 1

    def _spill(self, entry: ObjectEntry) -> None:
        """Write one entry to disk. Caller holds entry.lock (NOT the store
        lock) — only access to this object blocks on the disk write."""
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir, entry.object_id.hex())
        with open(path, "wb") as f:
            pickle.dump(entry.value, f, protocol=pickle.HIGHEST_PROTOCOL)
        entry.spill_path = path
        entry.value = None
        entry.tier = Tier.SPILLED
        with self._lock:
            self._host_bytes -= entry.nbytes
        self.stats["spills"] += 1
        self.stats["spilled_bytes"] += entry.nbytes

    def _restore(self, entry: ObjectEntry) -> Any:
        with open(entry.spill_path, "rb") as f:
            value = pickle.load(f)
        entry.value = value
        entry.tier = Tier.HOST
        with self._lock:
            self._host_bytes += entry.nbytes
        self.stats["restores"] += 1
        self.stats["restored_bytes"] += entry.nbytes
        return value

    # ------------------------------------------------------------------ intro

    def usage(self) -> Dict[str, int]:
        with self._lock:
            return {
                "host_bytes": self._host_bytes,
                "device_bytes": self._device_bytes,
                "capacity_bytes": self._capacity,
                "num_objects": len(self._entries),
            }
