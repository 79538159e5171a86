"""Model multiplexing: many models per replica with LRU residency.

A copy of `ray_tpu/serve/multiplex.py`: `@multiplexed` caches a replica's
model loader per model id with LRU eviction, and
`get_multiplexed_model_id` reads the current request's id. The router
prefers replicas that already hold the requested model (affinity in
router.py), so hot models stay loaded — the LoRA adapter-serving pattern.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Any, Callable, Optional

_context = threading.local()


def get_multiplexed_model_id() -> str:
    """The model id of the CURRENT request (inside a replica method),
    '' when the request carried none."""
    return getattr(_context, "model_id", "")


def _set_model_id(model_id: Optional[str]) -> None:
    _context.model_id = model_id or ""


def multiplexed(
    func: Optional[Callable] = None, *, max_num_models_per_replica: int = 3
):
    """Decorate a `def get_model(self, model_id)` loader: calls are cached
    per replica instance with LRU eviction beyond the cap, so switching
    between ≤N models costs one load each."""

    def wrap(fn: Callable) -> Callable:
        cache_attr = f"_serve_mux_{fn.__name__}"
        lock_attr = cache_attr + "_lock"

        @functools.wraps(fn)
        def loader(self, model_id: str) -> Any:
            lock = getattr(self, lock_attr, None)
            if lock is None:
                lock = threading.Lock()
                setattr(self, lock_attr, lock)
            with lock:
                cache = getattr(self, cache_attr, None)
                if cache is None:
                    cache = collections.OrderedDict()
                    setattr(self, cache_attr, cache)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
            model = fn(self, model_id)  # load OUTSIDE the lock (slow I/O)
            with lock:
                cache[model_id] = model
                cache.move_to_end(model_id)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)  # evict least-recently-used
            return model

        loader.__serve_multiplexed__ = True
        return loader

    return wrap(func) if func is not None else wrap
