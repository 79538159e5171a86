"""ctypes binding for the native arena object store (`native/objstore.cc`).

Port of `ray_tpu/core/native_store.py`. The C++ library owns placement
(first-fit free list with coalescing), pin counts and LRU order; this
wrapper owns the lifecycle and hands out zero-copy memoryviews into the
arena. A shared arena lives in a file (under /dev/shm) mapped
MAP_SHARED: worker processes map the same file and read a sealed payload
through its (offset, size) descriptor (`ShmView`), so its bytes never
cross a worker's pipe.

Build: at first use, `g++ -O2 -shared -fPIC -std=c++17` compiles
`native/objstore.cc` into `ray_tpu_torch/core/_native/libobjstore.so`
(ignored by git). The library is written to a temporary file and renamed
into place: the rename gives the .so a fresh inode, so a process that has
already loaded a stale copy (the ABI probe below) keeps its mapping, and
the next load maps the new file. A library whose ABI version differs from
`_ABI_VERSION`, or older than the source, is rebuilt.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libobjstore.so")
_SOURCE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native", "objstore.cc"
)

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None

# Must match store_abi_version() in native/objstore.cc: a stale library
# would otherwise be driven with the wrong signatures, silently, by ctypes.
_ABI_VERSION = 3


def _try_build() -> bool:
    """Compile the arena library; False (with `_build_error` set) when the
    source or the compiler is missing or the compile fails."""
    global _build_error
    if not os.path.exists(_SOURCE):
        _build_error = f"source {_SOURCE} not found"
        return False
    os.makedirs(_NATIVE_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-Wall", "-o", tmp, _SOURCE],
            capture_output=True, check=True, timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        stderr = getattr(exc, "stderr", b"") or b""
        _build_error = f"{exc!r} {stderr.decode(errors='replace')[-2000:]}"
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _abi_matches(path: str) -> bool:
    try:
        probe = ctypes.CDLL(path)
    except OSError:
        return False
    fn = getattr(probe, "store_abi_version", None)
    if fn is None:
        return False
    fn.restype = ctypes.c_uint64
    fn.argtypes = [ctypes.c_void_p]
    return fn(None) == _ABI_VERSION


def _stale(path: str) -> bool:
    if not os.path.exists(path):
        return True
    if os.path.exists(_SOURCE) and os.path.getmtime(_SOURCE) > os.path.getmtime(path):
        return True
    return not _abi_matches(path)


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _stale(_LIB_PATH) and not _try_build():
            return None
        if not _abi_matches(_LIB_PATH):
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.store_create_arena.restype = ctypes.c_void_p
        lib.store_create_arena.argtypes = [ctypes.c_uint64]
        lib.store_create_arena_shared.restype = ctypes.c_void_p
        lib.store_create_arena_shared.argtypes = [ctypes.c_uint64, ctypes.c_char_p]
        lib.store_destroy_arena.argtypes = [ctypes.c_void_p]
        lib.store_create.restype = ctypes.c_int64
        lib.store_create.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.store_seal.restype = ctypes.c_int
        lib.store_seal.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.store_get.restype = ctypes.c_int64
        lib.store_get.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.store_unpin.restype = ctypes.c_int
        lib.store_unpin.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.store_delete.restype = ctypes.c_int
        lib.store_delete.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.store_make_evictable.restype = ctypes.c_int
        lib.store_make_evictable.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.store_lru_candidate.restype = ctypes.c_int
        lib.store_lru_candidate.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        for name in ("store_used", "store_capacity", "store_num_objects",
                     "store_num_free_blocks"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        lib.store_base.restype = ctypes.c_void_p
        lib.store_base.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def build_error() -> Optional[str]:
    """Why the last build failed (None if none failed)."""
    return _build_error


class NativeArena:
    """One arena. Not a singleton: the tiered ObjectStore owns one as its
    shared-memory tier; tests create scratch arenas freely."""

    def __init__(self, capacity: int, path: Optional[str] = None):
        """path=None: a process-private malloc arena. path=str: the arena's
        pages live in that file (put it under /dev/shm), mapped
        MAP_SHARED, so worker processes can map it too."""
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(
                f"native object store unavailable (build failed: {_build_error})"
            )
        self._lib = lib
        self.path = path
        if path is None:
            self._arena = lib.store_create_arena(capacity)
        else:
            self._arena = lib.store_create_arena_shared(capacity, path.encode())
        if not self._arena:
            raise MemoryError(f"cannot allocate {capacity}-byte arena")
        self._base = lib.store_base(self._arena)
        self._closed = False

    def put(self, object_id: int, payload, evictable: bool = True) -> bool:
        """Copy payload into the arena and seal. False if it does not fit
        (the caller evicts through lru_candidate, or put_with_eviction).

        evictable=False leaves the object out of the LRU (readable, never a
        victim) until make_evictable(): a caller finishes its own
        bookkeeping before an eviction can race with it."""
        view = memoryview(payload)
        size = view.nbytes
        offset = self._lib.store_create(self._arena, object_id, size)
        if offset < 0:
            return False
        ctypes.memmove(self._base + offset, (ctypes.c_char * size).from_buffer_copy(view), size)
        self._lib.store_seal(self._arena, object_id)
        if evictable:
            self._lib.store_make_evictable(self._arena, object_id)
        return True

    def make_evictable(self, object_id: int) -> None:
        self._lib.store_make_evictable(self._arena, object_id)

    def get(self, object_id: int) -> Optional[memoryview]:
        """Zero-copy view, pinned until `unpin(object_id)`."""
        size = ctypes.c_uint64()
        offset = self._lib.store_get(self._arena, object_id, ctypes.byref(size))
        if offset < 0:
            return None
        buf = (ctypes.c_char * size.value).from_address(self._base + offset)
        return memoryview(buf)

    def descriptor(self, object_id: int):
        """(path, offset, size) of a sealed object, PINNED until
        release_descriptor: the handle a worker process maps. None for a
        private arena or an absent object."""
        if self.path is None:
            return None
        size = ctypes.c_uint64()
        offset = self._lib.store_get(self._arena, object_id, ctypes.byref(size))
        if offset < 0:
            return None
        return (self.path, int(offset), int(size.value))

    def release_descriptor(self, object_id: int) -> None:
        self.unpin(object_id)

    def unpin(self, object_id: int) -> None:
        self._lib.store_unpin(self._arena, object_id)

    def delete(self, object_id: int) -> bool:
        return self._lib.store_delete(self._arena, object_id) == 0

    def lru_candidate(self) -> Optional[int]:
        out = ctypes.c_uint64()
        rc = self._lib.store_lru_candidate(self._arena, ctypes.byref(out))
        return None if rc != 0 else int(out.value)

    def put_with_eviction(self, object_id: int, payload, on_evict=None, on_evicted=None,
                          evictable: bool = True) -> bool:
        """put(), evicting LRU objects until it fits.

        on_evict(id, view) runs before each deletion (the spill-prepare
        hook); on_evicted(id) runs only once the arena block is freed (the
        commit hook): if the delete fails (a concurrent get pinned the
        victim), the caller's bookkeeping is left untouched."""
        while True:
            if self.put(object_id, payload, evictable=evictable):
                return True
            victim = self.lru_candidate()
            if victim is None:
                return False
            if on_evict is not None:
                view = self.get(victim)
                try:
                    on_evict(victim, view)
                finally:
                    self.unpin(victim)
            if not self.delete(victim):
                return False
            if on_evicted is not None:
                on_evicted(victim)

    @property
    def used(self) -> int:
        return self._lib.store_used(self._arena)

    @property
    def capacity(self) -> int:
        return self._lib.store_capacity(self._arena)

    @property
    def num_objects(self) -> int:
        return self._lib.store_num_objects(self._arena)

    @property
    def num_free_blocks(self) -> int:
        return self._lib.store_num_free_blocks(self._arena)

    def close(self) -> None:
        if not self._closed:
            self._lib.store_destroy_arena(self._arena)
            if self.path is not None:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


# ------------------------------------------------------- cross-process views


_worker_mmaps: dict = {}
_worker_mmaps_lock = threading.Lock()


def _materialize_view(path: str, offset: int, count: int, dtype_str: str, shape: tuple):
    """Worker-side half of the descriptor protocol: map the arena file once
    per process (read-only) and return a zero-copy numpy view of the
    sealed payload. Objects are immutable: the array is read-only; copy
    it to change it."""
    import mmap as _mmap

    import numpy as np

    with _worker_mmaps_lock:
        mm = _worker_mmaps.get(path)
        if mm is None:
            fd = os.open(path, os.O_RDONLY)
            try:
                mm = _mmap.mmap(fd, 0, prot=_mmap.PROT_READ)
            finally:
                os.close(fd)
            _worker_mmaps[path] = mm
    arr = np.frombuffer(mm, dtype=np.dtype(dtype_str), count=count, offset=offset)
    return arr.reshape(shape)


class ShmView:
    """Pickles as a descriptor, unpickles as a read-only zero-copy numpy
    view over the shared arena: the bytes never cross the worker's pipe."""

    __slots__ = ("path", "offset", "count", "dtype_str", "shape")

    def __init__(self, path: str, offset: int, count: int, dtype_str: str, shape: tuple):
        self.path = path
        self.offset = offset
        self.count = count
        self.dtype_str = dtype_str
        self.shape = tuple(shape)

    def __reduce__(self):
        return (
            _materialize_view,
            (self.path, self.offset, self.count, self.dtype_str, self.shape),
        )
