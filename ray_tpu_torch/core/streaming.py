"""Streaming generators: tasks/actor methods that yield a stream of objects.

Port of `ray_tpu/core/streaming.py`. ``num_returns="streaming"`` tasks and
actor methods return an `ObjectRefGenerator` the consumer iterates while
the producer is still running. Each yielded value is sealed into its own
ObjectID (task_id ⊕ yield index) the moment it is produced, so consumers
overlap with producers — the substrate of serve's streaming responses
(`LLMServer.stream_generate` through a streaming handle) and of the data
plane's streaming reads (`data.from_generator`), whose producer a task's
`stream_max_backlog` holds to the consumer's pace (`_wait_backlog`).

The stream is an in-process handoff queue of ObjectRefs; the *values* live
in the ordinary tiered object store with lineage (a lost item re-executes
the generator task, which re-seals every yield index deterministically).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional


class ObjectRefGenerator:
    """Iterator over the ObjectRefs of a streaming task.

    Consumer side: ``for ref in gen: value = ray_tpu_torch.get(ref)`` — blocks
    until the next item is yielded or the stream finishes. A mid-stream
    producer error is raised from ``__next__`` after all successfully
    yielded items have been consumed.

    Producer side (scheduler / actor executor threads) appends sealed
    object ids via `_append_oid` and closes with `_finish`. `_appended`
    counts items already delivered; a retry of the producer task skips
    re-appending those indices (values re-seal idempotently).
    """

    def __init__(self, task_id, runtime):
        self._task_id = task_id
        self._runtime = runtime
        self._cond = threading.Condition()
        self._refs: List[Any] = []
        self._read = 0
        self._done = False
        self._error: Optional[BaseException] = None
        self._abandoned = False

    def __del__(self):
        # a dropped consumer must unblock a backpressured producer (and
        # stops the router's failover feeder)
        try:
            with self._cond:
                self._abandoned = True
                self._cond.notify_all()
        except Exception:
            pass

    # ---------------------------------------------------------------- producer

    @property
    def _appended(self) -> int:
        with self._cond:
            return len(self._refs)

    def _append_oid(self, object_id) -> None:
        from .runtime import ObjectRef

        ref = ObjectRef(object_id, self._runtime)
        with self._cond:
            self._refs.append(ref)
            self._cond.notify_all()

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._done:
                return
            self._done = True
            self._error = error
            self._cond.notify_all()

    def _wait_backlog(self, max_backlog: int, timeout: Optional[float] = None) -> None:
        """Producer-side flow control: block until the consumer has fewer
        than max_backlog unread items (the streaming analogue of the
        bounded in-flight window). Raises if the consumer abandoned the
        stream, so a backpressured producer never blocks forever."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: (len(self._refs) - self._read) < max_backlog
                or self._abandoned,
                timeout,
            )
            if self._abandoned:
                raise RuntimeError(
                    "stream consumer abandoned the generator; stopping producer"
                )
            if not ok:
                raise TimeoutError(
                    f"stream backlog stayed at {max_backlog} for {timeout}s"
                )

    # ---------------------------------------------------------------- consumer

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self):
        return self.next_ready(timeout=None)

    def next_ready(self, timeout: Optional[float] = None):
        """Next ObjectRef; raises StopIteration at end-of-stream, the
        producer's error after the last good item, or GetTimeoutError."""
        from .exceptions import GetTimeoutError

        with self._cond:
            while self._read >= len(self._refs) and not self._done:
                if not self._cond.wait(timeout):
                    raise GetTimeoutError(
                        f"no stream item within {timeout}s (got {self._read})"
                    )
            if self._read < len(self._refs):
                ref = self._refs[self._read]
                # Drop our copy of the handed-out ref: the stream must not
                # pin every streamed value for its whole lifetime (the
                # reference's ObjectRefStream likewise consumes items on
                # TryReadObjectRefStream). The consumer now owns the ref.
                self._refs[self._read] = None
                self._read += 1
                self._cond.notify_all()  # wake a backpressured producer
                return ref
            if self._error is not None:
                raise self._error
            raise StopIteration

    def completed(self) -> bool:
        with self._cond:
            return self._done

    def total_yielded(self) -> int:
        with self._cond:
            return len(self._refs)

    def __repr__(self):
        with self._cond:
            return (
                f"ObjectRefGenerator(task={self._task_id.hex()[:12]}, "
                f"yielded={len(self._refs)}, done={self._done})"
            )
