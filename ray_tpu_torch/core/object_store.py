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
release and against spilling; `free` drops an object at once.

SHM: with `cfg.native_store`, a numpy array of at least
``cfg.shm_min_bytes`` (not of object dtype) is copied into the native
arena (`native_store.py`), whose pages live in a file under /dev/shm
(`ray_tpu_torch_arena_<pid>_<id>`; files of dead processes are removed
when a store starts). Beyond JAX's tier, a Data block (a dict of such
arrays, `data/block.py`) of at least that size enters the arena too, as
one object. A thread reader gets a copy; a process-executor task gets a
pinned descriptor per array (`resolve_process_args`), which the worker
maps as a read-only view. The arena's LRU evicts to the spill dir (or to
LOST). The arena is capped at the free bytes of its directory (writing
past a full tmpfs kills the process with SIGBUS). When the library
cannot be built or the arena cannot be mapped, the store runs without
the tier, as JAX's does, and records why in `arena_error`. The JAX
package's REMOTE tier (a value in another node's store, borrowed
references) comes with clusters.
"""

from __future__ import annotations

import enum
import hashlib
import logging
import os
import pickle
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .exceptions import GetTimeoutError, ObjectLostError
from .ids import ObjectID


class Tier(enum.Enum):
    INLINE = "inline"      # small host objects, kept as-is in process
    HOST = "host"          # large host objects (numpy, CPU tensors), spillable
    DEVICE = "device"      # CUDA tensors, kept on the card, never spilled
    SHM = "shm"            # native arena (core/native_store.py): numpy arrays, Data blocks
    SPILLED = "spilled"    # on disk

logger = logging.getLogger(__name__)

ARENA_PREFIX = "ray_tpu_torch_arena_"
_ALIGN = 64  # the arena's own alignment; a block's arrays are packed at it


def shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def free_bytes(directory: str) -> int:
    st = os.statvfs(directory)
    return st.f_bavail * st.f_frsize


def _reap_stale_arenas(directory: str) -> None:
    """Unlink arena files whose owning process is gone: a SIGKILLed process
    must not leak RAM-backed tmpfs files (the names embed the creator's
    pid so this sweep can tell)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        if not name.startswith(ARENA_PREFIX):
            continue
        try:
            pid = int(name[len(ARENA_PREFIX):].split("_")[0])
        except ValueError:
            continue
        try:
            os.kill(pid, 0)  # probe: raises if the pid is gone
        except ProcessLookupError:
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass
        except PermissionError:
            pass  # someone else's live process


def _shm_array(value: Any) -> bool:
    return isinstance(value, np.ndarray) and value.dtype != object


def _shm_block(value: Any) -> bool:
    """A Data block the arena takes: a non-empty dict of str -> numpy
    arrays, none of object dtype."""
    return (isinstance(value, dict) and bool(value)
            and all(isinstance(k, str) and _shm_array(v) for k, v in value.items()))


def _shm_decode(meta, view, copy: bool):
    """The value behind an arena object's view: an array, or a block's
    dict of arrays. copy=False returns views into the arena."""
    if meta[0] == "__shm__":
        _, _, dtype_str, shape = meta
        arr = np.frombuffer(view, dtype=np.dtype(dtype_str)).reshape(shape)
        return arr.copy() if copy else arr
    out = {}
    for key, dtype_str, shape, offset, nbytes in meta[2]:
        dtype = np.dtype(dtype_str)
        if nbytes == 0:
            out[key] = np.empty(shape, dtype)
            continue
        arr = np.frombuffer(view, dtype=dtype, count=nbytes // dtype.itemsize,
                            offset=offset).reshape(shape)
        out[key] = arr.copy() if copy else arr
    return out


def _pack_block(block) -> tuple:
    """(uint8 buffer, layout) of a block's arrays packed at _ALIGN."""
    layout, cursor = [], 0
    for key, arr in block.items():
        layout.append((key, str(arr.dtype), arr.shape, cursor, arr.nbytes))
        cursor += -(-arr.nbytes // _ALIGN) * _ALIGN
    buf = np.empty(max(cursor, 1), np.uint8)
    for (key, _, _, offset, nbytes), arr in zip(layout, block.values()):
        buf[offset:offset + nbytes] = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return buf, layout


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
        self._shm_min = cfg.shm_min_bytes
        self.stats = {
            "puts": 0, "gets": 0, "spills": 0, "restores": 0, "evictions": 0,
            "shm_puts": 0, "shm_evictions": 0, "reconstructions": 0, "gc": 0,
            "spilled_bytes": 0, "restored_bytes": 0,
        }
        # The shared-memory tier: large numpy arrays (and Data blocks) in
        # the native arena, whose file worker processes map
        self._arena = None
        self.arena_error: Optional[str] = None
        if cfg.native_store:
            self._open_arena(capacity_bytes)
        self._shm_entries: Dict[int, ObjectID] = {}  # arena id -> object id  # guarded-by: _lock
        # Lineage resubmission hook (Runtime wires scheduler.submit here):
        # get() of a LOST entry with a recorded owner_task re-executes it.
        self._resubmit: Optional[Callable[[Any], None]] = None
        self._reconstruct_lock = threading.Lock()
        self.max_reconstructions = 3

    def set_resubmit(self, fn: Callable[[Any], None]) -> None:
        self._resubmit = fn

    def _open_arena(self, capacity_bytes: int) -> None:
        from .native_store import NativeArena, build_error, native_available

        try:
            if not native_available():
                self.arena_error = f"native library unavailable: {build_error()}"
            else:
                directory = shm_dir()
                _reap_stale_arenas(directory)
                room = free_bytes(directory)
                if capacity_bytes > room:
                    logger.warning("the arena is capped at %d bytes, the free bytes of %s "
                                   "(asked for %d)", room, directory, capacity_bytes)
                    capacity_bytes = room
                path = os.path.join(
                    directory, f"{ARENA_PREFIX}{os.getpid()}_{uuid.uuid4().hex[:8]}")
                self._arena = NativeArena(capacity_bytes, path=path)
        except (OSError, RuntimeError, MemoryError) as exc:
            self._arena = None
            self.arena_error = repr(exc)
        if self._arena is None:
            logger.warning("native_store is set but the arena is off: %s", self.arena_error)

    @property
    def arena(self):
        """The native arena of the SHM tier, or None."""
        return self._arena

    def close_arena(self) -> None:
        """Unmap the arena and remove its file. Its SHM objects are lost;
        later reads raise ObjectLostError."""
        with self._lock:
            arena, self._arena = self._arena, None
            self._shm_entries.clear()
        if arena is not None:
            arena.close()

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

    def _try_shm_seal(self, object_id: ObjectID, value: Any, nbytes: int):
        """Place a large numpy array or Data block into the native arena;
        returns the SHM metadata value, or None to fall through to the
        host tier.

        Runs OUTSIDE the store lock: put_with_eviction may spill victims
        to disk (pickle I/O in _on_arena_evict), and the arena has its own
        mutex. Only the _shm_entries map is touched under the store lock."""
        arena = self._arena
        if arena is None:
            return None
        if _shm_array(value) and nbytes >= self._shm_min:
            kind, tail = "__shm__", (str(value.dtype), value.shape)
            payload = np.ascontiguousarray(value).reshape(-1).view(np.uint8).data
        elif _shm_block(value) and sum(v.nbytes for v in value.values()) >= self._shm_min:
            payload, layout = _pack_block(value)
            kind, tail = "__shm_block__", (layout,)
        else:
            return None
        # Arena ids are 64-bit: hash the FULL object id (the return index
        # sits in its trailing bytes).
        aid = int.from_bytes(
            hashlib.blake2b(object_id.hex().encode(), digest_size=8).digest(), "big"
        )
        with self._lock:
            # A hash collision with a live object falls through to the
            # host tier instead of posing as out-of-space
            if aid in self._shm_entries:
                return None
            # map aid -> oid BEFORE placement so a concurrent seal's
            # eviction hooks can always resolve this block
            self._shm_entries[aid] = object_id
        # evictable=False: not an LRU candidate until seal() commits the
        # entry under the store lock and calls make_evictable
        ok = False
        try:
            ok = arena.put_with_eviction(
                aid, payload, on_evict=self._on_arena_evict,
                on_evicted=self._on_arena_evicted, evictable=False,
            )
        finally:
            if not ok:  # failure OR a raising spill hook: unregister the aid
                with self._lock:
                    self._shm_entries.pop(aid, None)
        if not ok:
            return None
        self.stats["shm_puts"] += 1
        return (kind, aid) + tail

    def seal(self, object_id: ObjectID, value: Any) -> None:
        nbytes = _estimate_nbytes(value)
        # Arena placement (and any victim spilling it triggers) happens
        # before taking the store lock: disk I/O must never run under it.
        shm_meta = self._try_shm_seal(object_id, value, nbytes)
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
            if shm_meta is not None:
                tier = Tier.SHM
                if shm_meta[0] == "__shm_block__":
                    nbytes = sum(v.nbytes for v in value.values())
                value = shm_meta
            elif _is_device_array(value):
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
        if shm_meta is not None and self._arena is not None:
            # entry committed: the arena block may now become an LRU victim
            self._arena.make_evictable(shm_meta[1])
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
                    elif entry.tier == Tier.SHM:
                        value = self._shm_get(entry)
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
            elif entry.tier == Tier.SHM:
                aid = entry.value[1]
                with self._lock:
                    arena = self._arena
                    self._shm_entries.pop(aid, None)
                if arena is not None:
                    arena.delete(aid)
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

    def _shm_get(self, entry: ObjectEntry):
        """Copy a value out of the arena: in-process readers must not hold
        views into a block the allocator may recycle (worker processes
        get pinned descriptors instead, resolve_process_args)."""
        arena = self._arena
        aid = entry.value[1]
        view = arena.get(aid) if arena is not None else None
        if view is None:  # evicted to disk between seal and get, or closed
            if entry.spill_path:
                return self._restore(entry)
            raise ObjectLostError(entry.object_id)
        try:
            return _shm_decode(entry.value, view, copy=True)
        finally:
            arena.unpin(aid)

    def _on_arena_evict(self, aid: int, view) -> None:
        """Spill-PREPARE: the arena's LRU chose a victim: write its bytes to
        disk (with a spill dir) but leave all bookkeeping intact. The state
        changes in _on_arena_evicted, once the block is freed, so a failed
        delete (victim pinned by a concurrent get) leaves it usable."""
        with self._lock:
            object_id = self._shm_entries.get(aid)
            entry = self._entries.get(object_id) if object_id is not None else None
        if entry is None or self._spill_dir is None:
            return
        with entry.lock:
            os.makedirs(self._spill_dir, exist_ok=True)
            path = os.path.join(self._spill_dir, entry.object_id.hex())
            with open(path, "wb") as f:
                pickle.dump(_shm_decode(entry.value, view, copy=True), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            entry.spill_path = path

    def _on_arena_evicted(self, aid: int) -> None:
        """Spill-COMMIT: the arena block is gone; flip the entry's tier."""
        with self._lock:
            object_id = self._shm_entries.pop(aid, None)
            entry = self._entries.get(object_id) if object_id is not None else None
        if entry is None:
            return
        with entry.lock:
            if entry.spill_path is not None:
                entry.tier = Tier.SPILLED
                self.stats["spills"] += 1
                self.stats["spilled_bytes"] += entry.nbytes
            else:
                entry.value = None
                entry.state = ObjectState.LOST
                self.stats["evictions"] += 1
        self.stats["shm_evictions"] += 1

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

    # -------------------------------------------------- process-worker views

    def resolve_process_args(self, container):
        """Resolve task args for a process-executor worker: an SHM-tier
        value becomes pinned zero-copy descriptors (`ShmView`: the array,
        or a block's dict of them) that the worker maps instead of
        receiving pickled bytes over its pipe. Everything else resolves by
        value. Returns (resolved, release): call release() once the worker
        is done to drop the pins."""
        from .native_store import ShmView
        from .runtime import ObjectRef

        pinned: List[int] = []
        arena = self._arena

        def one(value):
            if not isinstance(value, ObjectRef):
                return value
            entry = self.entry(value.object_id)
            if arena is not None and arena.path is not None and entry is not None:
                # under entry.lock like every reader: an arena eviction
                # flips value and state
                with entry.lock:
                    meta = entry.value if (entry.state == ObjectState.READY
                                           and entry.tier == Tier.SHM) else None
                    desc = arena.descriptor(meta[1]) if meta is not None else None  # pins
                if desc is not None:
                    path, offset, size = desc
                    pinned.append(meta[1])
                    if meta[0] == "__shm__":
                        _, _, dtype_str, shape = meta
                        count = size // np.dtype(dtype_str).itemsize
                        return ShmView(path, offset, count, dtype_str, shape)
                    return {
                        key: (ShmView(path, offset + off, nbytes // np.dtype(dtype_str).itemsize,
                                      dtype_str, shape)
                              if nbytes else np.empty(shape, np.dtype(dtype_str)))
                        for key, dtype_str, shape, off, nbytes in meta[2]
                    }
            return self.get(value.object_id)

        def release() -> None:
            for aid in pinned:
                arena.release_descriptor(aid)

        try:
            if isinstance(container, tuple):
                resolved = tuple(one(v) for v in container)
            else:
                resolved = {k: one(v) for k, v in container.items()}
        except BaseException:
            release()  # pins taken before the failing arg must not leak
            raise
        return resolved, release

    # ------------------------------------------------------------------ intro

    def usage(self) -> Dict[str, int]:
        with self._lock:
            return {
                "host_bytes": self._host_bytes,
                "device_bytes": self._device_bytes,
                "capacity_bytes": self._capacity,
                "num_objects": len(self._entries),
            }
