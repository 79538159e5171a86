"""Queue: an actor-backed FIFO shared by tasks and actors.

Port of `ray_tpu/util/queue.py` over the port's thread actors (reference
parity: ray.util.queue.Queue) — put/get/qsize from any task or actor,
Empty/Full mirroring the stdlib queue exceptions.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

from .. import api


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._items: List[Any] = []

    def put(self, item: Any) -> bool:
        if self.maxsize > 0 and len(self._items) >= self.maxsize:
            return False
        self._items.append(item)
        return True

    def get(self) -> tuple:
        if not self._items:
            return (False, None)
        return (True, self._items.pop(0))

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return 0 < self.maxsize <= len(self._items)


class Queue:
    """A FIFO visible to every task and actor. Pass the Queue object into
    tasks/actors; all holders share the one backing actor."""

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        cls = api.remote(_QueueActor)
        if actor_options:
            cls = cls.options(**actor_options)
        self._actor = cls.remote(maxsize)
        self.maxsize = maxsize

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if api.get(self._actor.put.remote(item)):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() >= deadline:
                raise Full
            time.sleep(0.01)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = api.get(self._actor.get.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty
            time.sleep(0.01)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return api.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return api.get(self._actor.empty.remote())

    def full(self) -> bool:
        return api.get(self._actor.full.remote())

    def shutdown(self) -> None:
        try:
            api.kill(self._actor)
        except Exception:
            pass
