"""Mutable-object channels: versioned single-slot buffers with
reader / writer synchronization.

Port of `ray_tpu/experimental/channel.py` (reference: experimental
mutable objects, experimental_mutable_object_manager.h:44, and
shared_memory_channel.py:151), the substrate of compiled graphs between
thread actors. Actors of one runtime share an address space, so the
channel is a versioned slot and a condition variable: the reader gets
the writer's object itself, no serialization, and CUDA tensors pass as
the same tensor. A writer blocks until every declared reader consumed
the previous version; each reader sees each version exactly once.
Across processes, `shm_channel.ShmChannel` keeps the same semantics.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class ChannelClosedError(RuntimeError):
    pass


class _Sentinel:
    def __repr__(self):
        return "<channel-closed>"


_CLOSED = _Sentinel()


class Channel:
    """Single-slot, version-stamped, multi-reader channel."""

    def __init__(self, num_readers: int = 1):
        if num_readers < 1:
            raise ValueError("num_readers must be >= 1")
        self.num_readers = num_readers
        self._cond = threading.Condition()
        self._value: Any = None
        self._version = 0          # bumped on every write
        self._reads_left = 0       # readers yet to consume current version
        self._closed = False

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        """Publish the next version. Blocks until the previous version has
        been consumed by all readers (back-pressure, like the reference's
        writer semaphore)."""
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._reads_left == 0 or self._closed, timeout
            ):
                raise TimeoutError("channel write timed out (readers lagging)")
            if self._closed:
                raise ChannelClosedError("channel is closed")
            self._value = value
            self._version += 1
            self._reads_left = self.num_readers
            self._cond.notify_all()

    def read(self, last_version: int = -1, timeout: Optional[float] = None):
        """Consume the next version after `last_version`. Returns
        (value, version). Each reader must track its own cursor (a
        ChannelReader does this for you)."""
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._version > last_version and self._reads_left > 0
                or self._closed,
                timeout,
            ):
                raise TimeoutError("channel read timed out (no new version)")
            if self._closed and self._version <= last_version:
                raise ChannelClosedError("channel is closed")
            value, version = self._value, self._version
            self._reads_left -= 1
            if self._reads_left == 0:
                self._value = None  # release for GC; slot is consumable again
                self._cond.notify_all()
            return value, version

    def close(self) -> None:
        """Unblock everyone; further reads/writes raise ChannelClosedError."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed


class ChannelReader:
    """Cursor-tracking reader handle (one per consumer)."""

    def __init__(self, channel: Channel):
        self._channel = channel
        # start at the channel's current version: attach readers BEFORE the
        # first write (the DAG compiler does) or they miss in-flight values
        self._cursor = channel._version

    def read(self, timeout: Optional[float] = None) -> Any:
        value, version = self._channel.read(self._cursor, timeout)
        self._cursor = version
        return value
