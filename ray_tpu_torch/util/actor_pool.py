"""ActorPool: load-balance a stream of work over a fixed set of actors.

Port of `ray_tpu/util/actor_pool.py` over the port's thread actors
(reference parity: ray.util.ActorPool) — submit/map/map_unordered/
get_next over pre-created actors, reusing each as soon as it frees up.
Unlike JAX's, `has_next` counts pending results: after results come back
out of order, JAX's pool still reports one and waits on no refs.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List

from .. import api


class ActorPool:
    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; blocks if no actor is idle."""
        if not self._idle:
            self._wait_for_one()
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = (self._next_task_index, actor)
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_next(self) -> bool:
        # pending results, not the ordered cursor: an unordered get that
        # took a later index leaves the cursor behind (JAX's pool counts
        # the cursor and then waits on no refs)
        return bool(self._future_to_actor)

    def get_next(self, timeout: float = None) -> Any:
        """Next result IN SUBMISSION ORDER."""
        if not self.has_next():
            raise StopIteration("no pending results")
        while self._next_return_index not in self._index_to_future:
            self._next_return_index += 1  # taken earlier by get_next_unordered
        ref = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        value = api.get(ref, timeout=timeout)
        _, actor = self._future_to_actor.pop(ref)
        if actor is not None:  # None = already freed by a blocking submit
            self._idle.append(actor)
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Whichever pending result finishes first."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = api.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout
        )
        if not ready:
            from ..core.exceptions import GetTimeoutError

            raise GetTimeoutError(f"no result within {timeout}s")
        ref = ready[0]
        index, actor = self._future_to_actor.pop(ref)
        self._index_to_future.pop(index, None)
        # keep ordered bookkeeping consistent: skip this index when the
        # ordered cursor reaches it
        if index == self._next_return_index:
            self._next_return_index += 1
        if actor is not None:
            self._idle.append(actor)
        return api.get(ref, timeout=timeout)

    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]) -> Iterator[Any]:
        """Ordered streaming map (backpressured by pool size)."""
        for value in values:
            self.submit(fn, value)
            # drain eagerly once saturated so results stream out
            while not self._idle and self.has_next():
                yield self.get_next()
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]) -> Iterator[Any]:
        for value in values:
            if not self._idle:
                yield self.get_next_unordered()
            self.submit(fn, value)
        while self.has_next():
            yield self.get_next_unordered()

    def _wait_for_one(self) -> None:
        """Free ONE actor whose task completed, without consuming its
        result (it stays retrievable through get_next by index)."""
        candidates = [
            ref for ref, (_, actor) in self._future_to_actor.items()
            if actor is not None
        ]
        ready, _ = api.wait(candidates, num_returns=1)
        ref = ready[0]
        index, actor = self._future_to_actor[ref]
        self._future_to_actor[ref] = (index, None)
        self._idle.append(actor)

    @property
    def num_idle(self) -> int:
        return len(self._idle)
