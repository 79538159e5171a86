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
the tier, as JAX's does, and records why in `arena_error`.

REMOTE (a cluster, `core/cluster.py`): a task's result that stayed in
the executing node's store is sealed here as a placeholder holding that
node's address; the first `get` pulls it through the chunked transfer
(`fetch_object`) and caches it in its own tier, and a pull from a dead
node drops the entry to LOST (lineage re-executes the task). A ref that
crossed from another process is BORROWED: its entry records the owner's
address (`owner_addr`, and `fetch_addr` where the bytes live on a third
node), `get` pulls from there, and this process registers as a borrower
at the owner, whose `add_borrow` pins the value until the matching
`remove_borrow`. A ref with no owner or producer known here polls the
GCS object directory (`_locate`) for at most `cfg.foreign_locate_max_s`
before it drops to LOST. A value held for another process (`custodial`:
a big task result or a parked one) is released only by its owner's
`free` or the node's teardown, never by a local handle's death.
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
    REMOTE = "remote"      # value lives in another node's store (cluster)

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


class _RemoteFetchFailed(Exception):
    """Internal: a REMOTE-tier fetch-through failed (holder unreachable)."""

    def __init__(self, object_id, address):
        super().__init__(f"fetch of {object_id} from {address} failed")


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
        "remote_addr", "foreign", "owner_addr", "borrow_failed", "fetch_addr",
        "custodial",
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
        # Address of the executing node still holding a copy (cluster):
        # set by seal_remote, kept across fetch-through so releasing this
        # entry can free the remote copy too.
        self.remote_addr: Optional[str] = None
        # An entry made for a ref that arrived from ANOTHER process
        # (nothing local will ever seal it): the only entries worth a GCS
        # object-directory lookup on get().
        self.foreign = False
        # Borrowed reference: the address of the OWNING process whose
        # refcount pins the value. get() pulls from there; releasing this
        # entry sends an unborrow (never a free).
        self.owner_addr: Optional[str] = None
        # The borrow registration exhausted its retries: a later loss is
        # plausibly the borrow protocol's fault (ObjectLostError's note).
        self.borrow_failed = False
        # Where the VALUE lives when that differs from the owner (arg
        # locality: pull peer-to-peer, borrow at the owner).
        self.fetch_addr: Optional[str] = None
        # Held ON THE OWNER'S BEHALF (a big or parked task result): a local
        # handle's death releases only its borrow, never the value.
        self.custodial = False


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
        # Cluster hooks (set by core.cluster.ClusterContext):
        # _fetch_remote(object_id, address) pulls a REMOTE-tier value over
        # the wire; _locate(object_id) asks the GCS object directory where
        # an object this process has never seen lives; _free_remote and
        # _unborrow queue a free at the holder and an unborrow at the owner.
        self._fetch_remote: Optional[Callable[[ObjectID, str], Any]] = None
        self._locate: Optional[Callable[[ObjectID], Optional[str]]] = None
        self._free_remote: Optional[Callable[[ObjectID, str], None]] = None
        self._unborrow: Optional[Callable[[ObjectID, str], None]] = None
        # owner-side borrow registry: object id -> borrower addresses
        self._borrowers: Dict[ObjectID, set] = {}  # guarded-by: _lock

    def set_cluster_hooks(self, fetch_remote, locate, free_remote=None,
                          unborrow=None) -> None:
        self._fetch_remote = fetch_remote
        self._locate = locate
        self._free_remote = free_remote
        self._unborrow = unborrow

    # ----------------------------------------------------------- borrows
    # A peer that unpickled one of our refs pins the value here until it
    # unborrows. Borrows are keyed by the borrowing process's address, so
    # an unborrow whose borrow registration was lost in transit can never
    # release a pin that belongs to another live borrower.

    def add_borrow(self, object_id: ObjectID, borrower: str) -> bool:
        entry = self.entry(object_id)
        if entry is None:
            return False  # already gone: the borrower's get() will fail
        with self._lock:
            holders = self._borrowers.setdefault(object_id, set())
            if borrower in holders:
                return True  # duplicate registration: one pin per borrower
            holders.add(borrower)
        self.pin(object_id)
        return True

    def remove_borrow(self, object_id: ObjectID, borrower: str) -> None:
        with self._lock:
            holders = self._borrowers.get(object_id)
            if holders is None or borrower not in holders:
                return  # no matching recorded borrow: nothing to release
            holders.discard(borrower)
            if not holders:
                del self._borrowers[object_id]
        entry = self.entry(object_id)
        if entry is None:
            return
        self.unpin(object_id)
        with entry.lock:
            gc_now = (entry.pin_count == 0 and entry.handle_count == 0
                      and entry.event.is_set())
        if gc_now:
            # last borrower left after the owner's handles died: the
            # deferred GC the pin was blocking runs now
            self._gc_entry(entry)

    def release_borrows_from(self, borrower: str) -> int:
        """Drop every borrow a (dead) borrower registered — its unborrows
        will never arrive. Returns how many were released."""
        with self._lock:
            doomed = [oid for oid, holders in self._borrowers.items()
                      if borrower in holders]
        for oid in doomed:
            self.remove_borrow(oid, borrower)
        return len(doomed)

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
                # never CLEAR recorded lineage: a result push from a node
                # agent (object_transfer._push_end) creates without an owner
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

    def seal_remote(self, object_id: ObjectID, address: str, nbytes: int = 0) -> None:
        """Seal an object as a remote placeholder: the value stays in the
        store of the node at `address`; get() fetches through on first
        access and caches locally. No-op if the value already arrived (a
        push raced the location). `nbytes` (when the producer reported it)
        feeds argument locality before the value is ever pulled."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = self.create(object_id)
        with entry.lock, self._lock:
            if entry.state == ObjectState.READY:
                return
            entry.value = address
            entry.remote_addr = address
            if nbytes:
                entry.nbytes = nbytes
            entry.tier = Tier.REMOTE
            entry.state = ObjectState.READY
            entry.gc_done = False
            entry.error = None
            entry.last_access = time.monotonic()
            callbacks = list(entry.callbacks)
            entry.callbacks.clear()
        entry.event.set()
        for cb in callbacks:
            cb(entry)
        if entry.gc_on_seal:
            # every handle died while the task ran remotely: GC now, which
            # also frees the agent's copy through remote_addr
            entry.gc_on_seal = False
            self._gc_entry(entry)

    def _fetch_through(self, entry: ObjectEntry) -> Any:
        """Pull a REMOTE-tier value and cache it locally. Caller holds
        entry.lock (only access to THIS object blocks on the wire). On a
        transport failure the entry drops to LOST so get() can
        lineage-reconstruct; a device this process lacks raises as is."""
        from .rpc import DeviceUnavailableError

        address = entry.value
        try:
            value = self._fetch_remote(entry.object_id, address)
        except DeviceUnavailableError:
            raise
        except Exception:
            # a peer-located pull falls back to the owner, which can always
            # materialize its own object
            fallback = entry.owner_addr
            if not (fallback and fallback != address):
                entry.value = None
                entry.remote_addr = None  # holder unreachable: nothing to free
                entry.state = ObjectState.LOST
                entry.event.set()
                raise _RemoteFetchFailed(entry.object_id, address)
            try:
                value = self._fetch_remote(entry.object_id, fallback)
            except DeviceUnavailableError:
                raise
            except Exception:
                entry.value = None
                entry.remote_addr = None
                entry.state = ObjectState.LOST
                entry.event.set()
                raise _RemoteFetchFailed(entry.object_id, fallback)
        nbytes = _estimate_nbytes(value)
        with self._lock:
            entry.value = value
            entry.nbytes = nbytes
            if _is_device_array(value):
                entry.tier = Tier.DEVICE
                self._device_bytes += nbytes
            else:
                entry.tier = Tier.INLINE if nbytes <= self._inline_max else Tier.HOST
                self._host_bytes += nbytes
        return value

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
                entry.foreign = True  # no local producer registered it
        deadline = None if timeout is None else time.monotonic() + timeout
        if entry.owner_addr is not None and not entry.event.is_set():
            # borrowed ref: pull from where the value lives (a peer node
            # when the dispatcher knew better, else the owner)
            self.seal_remote(object_id, entry.fetch_addr or entry.owner_addr)
        if self._locate is not None and entry.foreign and not entry.event.is_set():
            self._await_location(entry, timeout, deadline)
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
                    done = True
                    if entry.tier == Tier.SPILLED:
                        value = self._restore(entry)
                        restored = True
                    elif entry.tier == Tier.SHM:
                        value = self._shm_get(entry)
                    elif entry.tier == Tier.REMOTE:
                        try:
                            value = self._fetch_through(entry)
                            # fetched bytes count against capacity like a
                            # disk restore: spill-check after
                            restored = True
                        except _RemoteFetchFailed:
                            # holder died: LOST now; lineage below
                            state = ObjectState.LOST
                            done = False
                    else:
                        value = entry.value
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
                raise ObjectLostError(
                    object_id,
                    "(The borrow registration to the owner failed after "
                    "retries; the owner may have released the value because "
                    "this process's pin never landed.)"
                    if entry.borrow_failed else "",
                )
            # PENDING again (a reconstruction won the race): just re-wait.
        self.stats["gets"] += 1
        if restored:
            # Outside entry.lock: spilling victims takes *their* entry locks,
            # and holding one entry lock while waiting on another is an ABBA
            # deadlock between two concurrent restores.
            self._maybe_spill()
        return value

    def _await_location(self, entry: ObjectEntry, timeout, deadline) -> None:
        """A ref that crossed from another process: nothing local will ever
        seal it — a push may arrive, or the value sits in a remote store
        registered in the GCS object directory. Poll the directory while
        waiting (the producer may register after this get() started), at
        most `cfg.foreign_locate_max_s`: with no location ever registered
        the entry drops to LOST, so lineage or ObjectLostError runs
        instead of a wait that never ends."""
        from .config import cfg

        object_id = entry.object_id
        poll = 0.02
        give_up = time.monotonic() + cfg.foreign_locate_max_s
        while not entry.event.is_set():
            try:
                address = self._locate(object_id)
            except Exception:
                address = None
            if address:
                self.seal_remote(object_id, address)
                return
            now = time.monotonic()
            remaining = None if deadline is None else deadline - now
            if remaining is not None and remaining <= 0:
                raise GetTimeoutError(
                    f"Get timed out after {timeout}s waiting for "
                    f"{object_id} (no location registered)"
                )
            if now >= give_up:
                with entry.lock:
                    if not entry.event.is_set():
                        entry.state = ObjectState.LOST
                        entry.event.set()
                return
            wait_s = poll if remaining is None else min(poll, remaining)
            entry.event.wait(wait_s)
            poll = min(poll * 2, 1.0)

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
                    # fully GC'd, or arriving from ANOTHER process) increfs
                    # a missing id. In a cluster the object directory may
                    # know where it lives, so leave it pending+foreign for
                    # get() to locate; standalone there is no producer, so
                    # surface the loss instead of a PENDING entry nothing
                    # will ever seal.
                    entry = self.create(object_id)
                    if self._locate is not None:
                        entry.foreign = True
                    else:
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
                if entry.event.is_set() or entry.owner_addr is not None:
                    # sealed, OR a borrowed entry never fetched: its
                    # unborrow must still reach the owner
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
            if entry.custodial:
                # held for the OWNER: the local handle's death releases only
                # its borrow registration; the owner's free releases the value
                if entry.owner_addr is not None and self._unborrow is not None:
                    try:
                        self._unborrow(entry.object_id, entry.owner_addr)
                    except Exception:
                        pass
                    entry.owner_addr = None
                return
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
        if entry.owner_addr is not None:
            # borrowed value: tell the owner we are done (an unborrow, NEVER
            # a free — the owner and other borrowers may live on)
            if self._unborrow is not None:
                try:
                    self._unborrow(entry.object_id, entry.owner_addr)
                except Exception:
                    pass
            entry.owner_addr = None
            entry.remote_addr = None  # the owner's copy is not ours to free
        elif entry.remote_addr is not None and self._free_remote is not None:
            # we OWN this object and the executing node still holds its
            # copy: ask it to release (queued, never blocks under locks)
            try:
                self._free_remote(entry.object_id, entry.remote_addr)
            except Exception:
                pass
            entry.remote_addr = None
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

    def has_primary_copy_at(self, address: str) -> bool:
        """Whether any object's primary copy lives in the remote store at
        `address`. The capacity plane does not retire a node whose store
        still holds one: terminating it would lose the only copy."""
        if not address:
            return False
        with self._lock:
            entries = list(self._entries.values())
        return any(e.tier == Tier.REMOTE and e.remote_addr == address for e in entries)

    def usage(self) -> Dict[str, int]:
        with self._lock:
            return {
                "host_bytes": self._host_bytes,
                "device_bytes": self._device_bytes,
                "capacity_bytes": self._capacity,
                "num_objects": len(self._entries),
            }
