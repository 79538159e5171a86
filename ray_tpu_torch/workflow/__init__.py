"""ray_tpu_torch.workflow — durable DAG execution (Ray Workflow equivalent).

Reference parity: python/ray/workflow — workflow_executor.py + storage-
backed step results (workflow_storage.py), resume-from-storage semantics.

Steps form a DAG via .step(...) binding; run() executes steps as runtime
tasks, persisting each result under storage/<workflow_id>/<step_id>.pkl.
Step ids are content-addressed (function name + argument structure), so
re-running the same program after a crash skips every step whose
result is already on disk — exactly-once-ish without a database.

Per-step robustness: `@workflow.step(max_retries=3)` re-runs a step that
raised (any exception) up to N times before the failure propagates, and
`@workflow.step(timeout_s=30)` bounds how long run() waits for the
step's result — a hung step surfaces WorkflowStepTimeout instead of
wedging the whole workflow. Both also available per-call through
`fn.options(...)`. Retry/timeout settings are not part of the step id,
so tuning them never invalidates persisted results.

Port of `ray_tpu/workflow/__init__.py`. A step id of plain arguments is
JAX's (the sha1 of their standard pickle), so a storage directory means
the same to both packages. A tensor argument, anywhere in an argument's
structure, is digested by its dtype, shape and bytes (torch's own pickle
of a tensor is a serialized storage, not a stable digest of its value):
equal values give equal ids across runs and processes, wherever the
tensor lives. Results persist with the standard pickle; a persisted CUDA
tensor reloads onto the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import pickle
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import api


class WorkflowStepTimeout(TimeoutError):
    """A step exceeded its timeout_s budget; its result never arrived."""


@dataclasses.dataclass(frozen=True)
class StepNode:
    fn: Callable
    args: Tuple[Any, ...]
    kwargs: Tuple[Tuple[str, Any], ...]
    name: str
    # robustness knobs — deliberately NOT hashed into step_id, so tuning
    # them on a resumed run still reuses persisted results
    max_retries: int = 0
    timeout_s: Optional[float] = None

    @property
    def step_id(self) -> str:
        h = hashlib.sha1()
        h.update(self.name.encode())
        for a in self.args:
            h.update(
                a.step_id.encode() if isinstance(a, StepNode) else _digest(a)
            )
        for k, v in self.kwargs:
            h.update(k.encode())
            h.update(v.step_id.encode() if isinstance(v, StepNode) else _digest(v))
        return f"{self.name}-{h.hexdigest()[:12]}"


class _DigestPickler(pickle.Pickler):
    """The standard pickle, but a tensor pickles as its dtype, shape and
    bytes (read back from the device where it lives)."""

    def reducer_override(self, obj):
        import torch

        if isinstance(obj, torch.Tensor):
            flat = obj.detach().reshape(-1).contiguous().cpu()
            return _tensor_digest_marker, (str(obj.dtype), tuple(obj.shape),
                                           flat.view(torch.uint8).numpy().tobytes())
        return NotImplemented


def _tensor_digest_marker(dtype: str, shape: tuple, data: bytes):
    """What `_DigestPickler` reduces a tensor to; never unpickled."""
    raise TypeError("a step-id digest is not a value")


def _digest(value: Any) -> bytes:
    try:
        buf = io.BytesIO()
        _DigestPickler(buf).dump(value)
        return hashlib.sha1(buf.getvalue()).digest()
    except Exception:
        return repr(value).encode()


class _StepFunction:
    def __init__(self, fn: Callable, name: Optional[str] = None,
                 max_retries: int = 0, timeout_s: Optional[float] = None):
        self._fn = fn
        self._name = name or fn.__name__
        self._max_retries = max_retries
        self._timeout_s = timeout_s

    def options(self, *, max_retries: Optional[int] = None,
                timeout_s: Optional[float] = None) -> "_StepFunction":
        """Per-call override of the step's retry/timeout settings."""
        return _StepFunction(
            self._fn, self._name,
            self._max_retries if max_retries is None else max_retries,
            self._timeout_s if timeout_s is None else timeout_s,
        )

    def step(self, *args, **kwargs) -> StepNode:
        return StepNode(
            self._fn, args, tuple(sorted(kwargs.items())), self._name,
            max_retries=self._max_retries, timeout_s=self._timeout_s,
        )

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def step(fn: Optional[Callable] = None, *, name: Optional[str] = None,
         max_retries: int = 0, timeout_s: Optional[float] = None):
    """@workflow.step decorator; build nodes with fn.step(...)."""
    if fn is None:
        return lambda f: _StepFunction(f, name, max_retries, timeout_s)
    return _StepFunction(fn, name, max_retries, timeout_s)


# ------------------------------------------------------------------ execution


class _Storage:
    def __init__(self, root: str, workflow_id: str):
        self.dir = os.path.join(os.fspath(root), workflow_id)
        os.makedirs(self.dir, exist_ok=True)

    def path(self, step_id: str) -> str:
        return os.path.join(self.dir, f"{step_id}.pkl")

    def has(self, step_id: str) -> bool:
        return os.path.exists(self.path(step_id))

    def load(self, step_id: str) -> Any:
        with open(self.path(step_id), "rb") as f:
            return pickle.load(f)

    def save(self, step_id: str, value: Any) -> None:
        tmp = self.path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, self.path(step_id))

    def completed_steps(self) -> List[str]:
        return sorted(
            f[:-4] for f in os.listdir(self.dir) if f.endswith(".pkl")
        )


def run(
    node: StepNode,
    *,
    storage: str,
    workflow_id: str = "default",
) -> Any:
    """Execute the DAG rooted at `node`; persisted steps are not re-run."""
    store = _Storage(storage, workflow_id)
    memo: Dict[str, Any] = {}  # step_id -> ObjectRef or loaded value

    def _persist_and_run(fn, step_id, store_dir, *resolved_args, **resolved_kwargs):
        result = fn(*resolved_args, **resolved_kwargs)
        s = _Storage(os.path.dirname(store_dir), os.path.basename(store_dir))
        s.save(step_id, result)
        return result

    run_step = api.remote(_persist_and_run)

    def submit(n: StepNode):
        sid = n.step_id
        if sid in memo:
            return memo[sid]
        if store.has(sid):
            memo[sid] = store.load(sid)
            return memo[sid]
        resolved_args = [submit(a) if isinstance(a, StepNode) else a for a in n.args]
        resolved_kwargs = {
            k: (submit(v) if isinstance(v, StepNode) else v) for k, v in n.kwargs
        }
        # args that are refs are resolved by the runtime before fn runs
        task = run_step
        if n.max_retries:
            task = run_step.options(
                max_retries=n.max_retries, retry_exceptions=True
            )
        ref = task.remote(n.fn, sid, store.dir, *resolved_args, **resolved_kwargs)
        if n.timeout_s is not None:
            # bound the wait HERE: downstream steps must never bind to a
            # ref that may hang forever
            from ..core.exceptions import GetTimeoutError

            try:
                value = api.get(ref, timeout=n.timeout_s)
            except GetTimeoutError:
                raise WorkflowStepTimeout(
                    f"step {sid} did not finish within {n.timeout_s}s"
                ) from None
            memo[sid] = value
            return value
        memo[sid] = ref
        return ref

    out = submit(node)
    return api.get(out) if not _is_plain(out) else out


def _is_plain(value: Any) -> bool:
    from ..core.runtime import ObjectRef

    return not isinstance(value, ObjectRef)


def list_completed(storage: str, workflow_id: str = "default") -> List[str]:
    return _Storage(storage, workflow_id).completed_steps()
