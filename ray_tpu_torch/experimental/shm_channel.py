"""Cross-process mutable-object channels over shared memory.

Port of `ray_tpu/experimental/shm_channel.py`, the substrate of compiled
graphs once one bound actor is a process actor (reference:
shared_memory_channel.py:151, experimental_mutable_object_manager.h:44).
One mmap'd file per channel (under /dev/shm when available), laid out as
JAX's, byte for byte, so either package can read the other's channel:

    header:  magic | num_readers | closed | version | data_len | capacity
    acks:    one u64 per reader: the last version that reader consumed
    data:    capacity bytes (the pickled payload)

Synchronization is lock-free: the writer waits until every ack equals
the current version (all readers consumed it), writes the payload, THEN
bumps the version; each reader waits for a version above its ack, reads,
and stores the new version into ITS OWN ack slot. Every shared word is an
aligned 8-byte slot written by exactly one side, so plain coherent stores
are enough.

MEMORY ORDERING: the payload -> data_len -> version store order is
published with plain stores, which a reader observes in order only under
TSO (x86-64); creation warns elsewhere. The H100's hosts are x86-64.

What differs from JAX: a payload holding a CUDA tensor is refused with a
TypeError before anything is written (`worker_pool.dumps`): a process
reading it would create a CUDA context; pass `.cpu()` tensors or numpy.
The port's files are named `ray_tpu_torch_chan_*`, and its reaper sweeps
only those.

Handles pickle as (path, layout) and re-open on the other side, so an
endpoint can ride into a process actor as a plain argument. Every open
endpoint holds a shared flock on its file: the stale-file reaper unlinks
a file only when an exclusive flock on it succeeds.
"""

from __future__ import annotations

import fcntl
import mmap
import os
import pickle
import struct
import tempfile
import time
from typing import Any, Optional

from ..core.worker_pool import dumps
from .channel import ChannelClosedError

_PREFIX = "ray_tpu_torch_chan_"
_MAGIC = 0x52545043484E4C31  # "RTPCHNL1"
_HDR = struct.Struct("<QQQQQQ")  # magic, num_readers, closed, version, data_len, capacity
_ACK = struct.Struct("<Q")
_U64 = struct.Struct("<Q")
# Byte offsets of the individually-owned header words. The single-writer
# discipline holds per WORD: magic/num_readers/capacity are written once
# at create; closed is written ONLY by close(); version and data_len ONLY
# by write(). No read-modify-write of the whole header ever happens after
# creation, so a close racing a write can neither be erased nor regress
# the version stamp.
_OFF_CLOSED = 16
_OFF_VERSION = 24
_OFF_DATA_LEN = 32


def _shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


_reaped_once = False


def _reap_stale_channels(shm_dir: str) -> None:
    """Unlink channel files no live ENDPOINT holds open: every open
    channel keeps a shared flock on its file, so an exclusive
    non-blocking flock succeeding proves abandonment (creator-pid would
    be the wrong proxy — dag pipelines outlive the process that created
    their channels, and PID namespaces lie across containers). Runs
    once per process: a SIGKILLed user must not leak tmpfs RAM forever,
    but per-creation directory scans would be pure overhead."""
    global _reaped_once
    if _reaped_once:
        return
    _reaped_once = True
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return
    for name in names:
        if not name.startswith(_PREFIX):
            continue
        path = os.path.join(shm_dir, name)
        try:
            fd = os.open(path, os.O_RDWR)
        except OSError:
            continue
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            continue  # some endpoint somewhere holds it: live
        try:
            os.unlink(path)  # abandoned: no endpoint held the lock
        except OSError:
            pass
        finally:
            os.close(fd)  # releases the exclusive lock


class ShmChannel:
    """Single-slot, version-stamped, multi-reader channel across OS
    processes on one host. Create once (create=True), hand the object to
    readers (it pickles by path); each reader calls ``reader(i)`` for
    its dedicated ack slot."""

    _warned_weak_ordering = False

    def __init__(self, capacity: int = 1 << 20, num_readers: int = 1,
                 path: Optional[str] = None, _create: bool = True):
        if num_readers < 1:
            raise ValueError("num_readers must be >= 1")
        import platform

        machine = platform.machine().lower()
        if machine not in ("x86_64", "amd64", "i686", "i386") and (
            not ShmChannel._warned_weak_ordering
        ):
            ShmChannel._warned_weak_ordering = True
            import warnings

            warnings.warn(
                "ShmChannel's lock-free protocol assumes TSO (x86) store "
                f"ordering; on {machine} a reader may observe a torn "
                "payload. See the module docstring.",
                RuntimeWarning,
            )
        self.capacity = int(capacity)
        self.num_readers = int(num_readers)
        self._data_off = _HDR.size + _ACK.size * self.num_readers
        if _create:
            if path is None:
                shm_dir = _shm_dir()
                _reap_stale_channels(shm_dir)
                fd, self.path = tempfile.mkstemp(
                    prefix=f"{_PREFIX}{os.getpid()}_", dir=shm_dir
                )
            else:
                fd, self.path = os.open(path, os.O_CREAT | os.O_RDWR), path
            try:
                # lease FIRST: between mkstemp and LOCK_SH the file would
                # otherwise be visible-but-unleased, and a concurrent
                # process's sweep could reap a channel being born
                fcntl.flock(fd, fcntl.LOCK_SH)
                os.ftruncate(fd, self._data_off + self.capacity)
                self._mm = mmap.mmap(fd, self._data_off + self.capacity)
            except BaseException:
                os.close(fd)
                if path is None:
                    try:
                        os.unlink(self.path)  # half-born mkstemp file
                    except OSError:
                        pass
                raise
            _HDR.pack_into(
                self._mm, 0, _MAGIC, self.num_readers, 0, 0, 0, self.capacity
            )
        else:
            self.path = path
            fd = os.open(path, os.O_RDWR)
            try:
                fcntl.flock(fd, fcntl.LOCK_SH)  # lease before anything else
                self._mm = mmap.mmap(fd, self._data_off + self.capacity)
            except BaseException:
                os.close(fd)
                raise
            magic, nr, _, _, _, cap = _HDR.unpack_from(self._mm, 0)
            if magic != _MAGIC or nr != self.num_readers or cap != self.capacity:
                os.close(fd)
                raise ValueError(f"channel file {path!r} does not match layout")
        # the fd stays OPEN holding the shared flock: it is this
        # endpoint's liveness lease — the stale-channel reaper only
        # unlinks files on which an exclusive flock succeeds
        self._fd = fd
        self._owner = _create

    # ------------------------------------------------------------- plumbing

    def _read_header(self):
        return _HDR.unpack_from(self._mm, 0)

    def _version(self) -> int:
        return _U64.unpack_from(self._mm, _OFF_VERSION)[0]

    def _closed(self) -> bool:
        return bool(_U64.unpack_from(self._mm, _OFF_CLOSED)[0])

    def _ack(self, i: int) -> int:
        return _ACK.unpack_from(self._mm, _HDR.size + _ACK.size * i)[0]

    def _set_ack(self, i: int, version: int) -> None:
        _ACK.pack_into(self._mm, _HDR.size + _ACK.size * i, version)

    @staticmethod
    def _wait(predicate, timeout: Optional[float], what: str) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        pause = 20e-6
        while not predicate():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"shm channel {what} timed out")
            time.sleep(pause)
            pause = min(pause * 2, 1e-3)

    # ------------------------------------------------------------------ API

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        """Publish the next version; blocks until every reader consumed
        the previous one (the reference's writer semaphore, as ack
        comparison)."""
        payload = dumps(value)
        if len(payload) > self.capacity:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds channel capacity "
                f"{self.capacity}; construct with a larger capacity"
            )
        version = self._version()
        self._wait(
            lambda: self._closed()
            or all(self._ack(i) >= version for i in range(self.num_readers)),
            timeout, "write",
        )
        if self._closed():
            raise ChannelClosedError("channel is closed")
        self._mm[self._data_off : self._data_off + len(payload)] = payload
        # data first, then length, then the version stamp — each its own
        # 8-byte store: a reader that observes the new version is
        # guaranteed to see the new payload, and the `closed` word (owned
        # by close()) is never rewritten here
        _U64.pack_into(self._mm, _OFF_DATA_LEN, len(payload))
        _U64.pack_into(self._mm, _OFF_VERSION, version + 1)

    def read(self, reader_id: int = 0, timeout: Optional[float] = None) -> Any:
        """Consume the next version (each reader sees each version exactly
        once). Raises ChannelClosedError once the writer closed and every
        version was consumed."""
        if not 0 <= reader_id < self.num_readers:
            raise ValueError(f"reader_id {reader_id} out of range")
        seen = self._ack(reader_id)
        self._wait(
            lambda: self._version() > seen or self._closed(), timeout, "read"
        )
        version = self._version()
        if version <= seen:  # closed with nothing new
            raise ChannelClosedError("channel is closed")
        data_len = _U64.unpack_from(self._mm, _OFF_DATA_LEN)[0]
        value = pickle.loads(self._mm[self._data_off : self._data_off + data_len])
        self._set_ack(reader_id, version)
        return value

    def reader(self, reader_id: int) -> "ShmChannelReader":
        return ShmChannelReader(self, reader_id)

    def close(self) -> None:
        # single 8-byte store into the word only close() owns — safe
        # against a concurrent write() stamping version/data_len
        _U64.pack_into(self._mm, _OFF_CLOSED, 1)

    def release(self) -> None:
        """Drop this endpoint's liveness lease (close its fd). Called by
        unlink()/GC; safe to call twice."""
        fd, self._fd = self._fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass

    def unlink(self) -> None:
        """Remove the backing file (creator only, after all ends closed)."""
        self.release()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass

    def __reduce__(self):
        return (
            _reopen_channel, (self.path, self.capacity, self.num_readers)
        )


def _reopen_channel(path: str, capacity: int, num_readers: int) -> ShmChannel:
    return ShmChannel(
        capacity=capacity, num_readers=num_readers, path=path, _create=False
    )


class ShmChannelReader:
    """A reader endpoint bound to one ack slot; picklable like the
    channel itself."""

    def __init__(self, channel: ShmChannel, reader_id: int):
        self.channel = channel
        self.reader_id = reader_id

    def read(self, timeout: Optional[float] = None) -> Any:
        return self.channel.read(self.reader_id, timeout)
