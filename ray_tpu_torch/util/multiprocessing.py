"""multiprocessing.Pool shim over the task runtime.

Port of `ray_tpu/util/multiprocessing.py`: a drop-in Pool whose work
runs as process-executor tasks (GIL-free parallelism for CPU functions)
with a bounded in-flight window. The function must be importable in the
worker (`core/worker_pool.check_importable`): a lambda or a nested
function raises TypeError when it is submitted, where JAX's cloudpickle
would carry it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

from .. import api


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None) -> Any:
        values = api.get(self._refs, timeout=timeout)
        return values[0] if self._single else values

    def wait(self, timeout: Optional[float] = None) -> None:
        api.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = api.wait(self._refs, num_returns=len(self._refs), timeout=0)
        return len(done) == len(self._refs)


class Pool:
    """Drop-in-ish multiprocessing.Pool: map/starmap/imap/apply_async.

    processes bounds CONCURRENT in-flight tasks (the worker pool itself
    is shared and flag-sized)."""

    def __init__(self, processes: Optional[int] = None):
        api.init(ignore_reinit_error=True)
        self._processes = processes or 4
        self._closed = False

    def _check(self):
        if self._closed:
            raise ValueError("Pool is closed")

    @staticmethod
    def _wrap(func: Callable):
        """The ONE place that decides how Pool work becomes tasks."""
        return api.remote(executor="process", num_cpus=1)(func)

    def apply(self, func: Callable, args: tuple = (), kwds: Optional[dict] = None) -> Any:
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args: tuple = (),
                    kwds: Optional[dict] = None) -> AsyncResult:
        self._check()
        return AsyncResult(
            [self._wrap(func).remote(*args, **(kwds or {}))], single=True
        )

    def map(self, func: Callable, iterable: Iterable[Any]) -> List[Any]:
        return list(self.imap(func, iterable))

    def starmap(self, func: Callable, iterable: Iterable[tuple]) -> List[Any]:
        self._check()
        return list(self._imap_args(func, iterable))

    def imap(self, func: Callable, iterable: Iterable[Any]):
        """Ordered streaming map with a bounded in-flight window."""
        self._check()
        return self._imap_args(func, ((x,) for x in iterable))

    def _imap_args(self, func: Callable, arg_tuples: Iterable[tuple]):
        remote_fn = self._wrap(func)
        pending: List[Any] = []
        for args in arg_tuples:
            pending.append(remote_fn.remote(*args))
            if len(pending) >= self._processes:
                yield api.get(pending.pop(0))
        for ref in pending:
            yield api.get(ref)

    def map_async(self, func: Callable, iterable: Iterable[Any]) -> AsyncResult:
        self._check()
        remote_fn = self._wrap(func)
        return AsyncResult([remote_fn.remote(x) for x in iterable])

    def close(self) -> None:
        self._closed = True

    def join(self) -> None:
        pass  # tasks are tracked by their refs; nothing to join

    def terminate(self) -> None:
        self._closed = True

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
