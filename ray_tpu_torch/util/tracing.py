"""End-to-end tracing: spans, context propagation across threads, export.

Port of `ray_tpu/util/tracing.py`: a lock-cheap in-process tracer with
64-bit hex trace_id/span_id/parent_id, a context-local "current span", and
explicit hops across threads (carry `current_context()` with the work item
and re-enter it with `use_context` or `start_span(parent=...)`). The
runtime opens a span on every task submit and actor call, the router on
every request.

Spans land in a per-process ring buffer (capacity
``cfg.trace_buffer_spans``) and are sampled per TRACE at the root
(``cfg.trace_sample_ratio``): an unsampled root hands every descendant an
unsampled context, so a whole request is either fully recorded or free.
Ending a span derives latency histograms (raytpu_task_queue_seconds,
raytpu_task_exec_seconds, raytpu_serve_ttft_seconds, ...) in
`util.metrics`. Export is chrome-trace/Perfetto JSON. The context also
crosses the cluster RPC as a `_trace_ctx` kwarg (`core/rpc.py` injects it
into call frames with `inject_context`, the serving side pops it with
`extract_context`), so one trace_id spans processes.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "tracer",
    "span",
    "start_span",
    "current_context",
    "use_context",
    "inject_context",
    "extract_context",
    "export_chrome_trace",
    "device_annotate",
]


def _new_id() -> str:
    return os.urandom(8).hex()


# The context-local current span context: {"trace_id", "span_id",
# "sampled"}. contextvars follow the thread that set them; hops across
# threads are EXPLICIT — carry `current_context()` with the work item and
# re-enter it with `use_context`/`start_span(parent=...)`.
_current: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None
)


class Span:
    """One timed operation. Not thread-safe for concurrent mutation, but
    start/end may happen on different threads (engine submit thread vs.
    loop thread) — `end()` is idempotent."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "start_ts", "end_ts",
        "attrs", "status", "lane", "sampled", "_tracer", "_token", "_ended",
    )

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 name: str, *, attrs: Optional[Dict[str, Any]] = None,
                 lane: str = "", sampled: bool = True,
                 start_ts: Optional[float] = None,
                 tracer_: "Optional[Tracer]" = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ts = time.time() if start_ts is None else start_ts
        self.end_ts = 0.0
        self.attrs = dict(attrs or {})
        self.status = "OK"
        self.lane = lane
        self.sampled = sampled
        self._tracer = tracer_
        self._token = None
        self._ended = False

    @property
    def context(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": self.sampled,
        }

    def set_attribute(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def end(self, status: str = "OK",
            end_ts: Optional[float] = None, **attrs: Any) -> None:
        if self._ended:
            return
        self._ended = True
        self.end_ts = time.time() if end_ts is None else end_ts
        self.status = status
        if attrs:
            self.attrs.update(attrs)
        if self.sampled and self._tracer is not None:
            self._tracer._record(self)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ts": self.start_ts,
            "end_ts": self.end_ts,
            "duration_s": max(0.0, self.end_ts - self.start_ts),
            "status": self.status,
            "lane": self.lane,
            "attrs": dict(self.attrs),
        }

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id[:8]}, "
                f"span={self.span_id[:8]}, parent={str(self.parent_id)[:8]})")


# ------------------------------------------------------- span-derived metrics

# span name -> (histogram name, description, bucket boundaries). Observed
# at end() so the waterfall and the /metrics scrape tell the same story.
_DURATION_METRICS: Dict[str, tuple] = {
    "task.queue": (
        "raytpu_task_queue_seconds",
        "Submit-to-dispatch queue latency of tasks, from spans.",
        (0.001, 0.01, 0.1, 1.0, 10.0),
    ),
    "task.execute": (
        "raytpu_task_exec_seconds",
        "Wall-clock execution time of tasks, from spans.",
        (0.001, 0.01, 0.1, 1.0, 10.0, 60.0),
    ),
    "transfer.pull": (
        "raytpu_transfer_seconds",
        "Node-to-node object transfer latency, from spans.",
        (0.001, 0.01, 0.1, 1.0, 10.0),
    ),
    "transfer.push": (
        "raytpu_transfer_seconds",
        "Node-to-node object transfer latency, from spans.",
        (0.001, 0.01, 0.1, 1.0, 10.0),
    ),
}

# attribute of an ending "serve.request"/"engine.request" span ->
# histogram. TTFT/TPOT/queue-time fall out of the request span instead of
# ad-hoc timers.
_SERVE_ATTR_METRICS: Dict[str, tuple] = {
    "ttft_s": (
        "raytpu_serve_ttft_seconds",
        "Time to first generated token, from engine request spans.",
        (0.005, 0.025, 0.1, 0.5, 2.0, 10.0),
    ),
    "tpot_s": (
        "raytpu_serve_tpot_seconds",
        "Time per output token after the first, from engine request spans.",
        (0.001, 0.005, 0.025, 0.1, 0.5),
    ),
    "queue_s": (
        "raytpu_serve_queue_seconds",
        "Engine admission queue wait, from engine request spans.",
        (0.001, 0.01, 0.1, 1.0, 10.0),
    ),
}


def _observe_derived(span_: Span) -> None:
    from .metrics import get_or_create_histogram

    spec = _DURATION_METRICS.get(span_.name)
    if spec is not None:
        name, desc, bounds = spec
        tags = None
        if span_.name.startswith("transfer."):
            tags = {"direction": span_.name.split(".", 1)[1]}
        get_or_create_histogram(name, desc, boundaries=bounds,
                                tag_keys=("direction",) if tags else ()).observe(
            max(0.0, span_.end_ts - span_.start_ts), tags=tags
        )
    if span_.name in ("engine.request", "serve.request"):
        for attr, (name, desc, bounds) in _SERVE_ATTR_METRICS.items():
            value = span_.attrs.get(attr)
            if isinstance(value, (int, float)) and value >= 0:
                get_or_create_histogram(name, desc, boundaries=bounds).observe(
                    float(value)
                )


# ------------------------------------------------------------------- tracer


class Tracer:
    """Per-process span sink: a ring buffer plus the sampling decision.

    Lock discipline: one mutex guards only the deque/index bookkeeping in
    `_record`; span creation takes no lock at all (ids are os.urandom,
    the sampling roll is thread-local random), so tracing stays off the
    hot path's contention profile."""

    def __init__(self, capacity: Optional[int] = None,
                 sample_ratio: Optional[float] = None):
        from ..core.config import cfg

        self._capacity = capacity or cfg.trace_buffer_spans
        self._sample_ratio = sample_ratio
        self._buf: "deque[Dict[str, Any]]" = deque(maxlen=self._capacity)
        self._lock = threading.Lock()

    # -------------------------------------------------------------- creation

    def _sampled(self) -> bool:
        ratio = self._sample_ratio
        if ratio is None:
            from ..core.config import cfg

            ratio = cfg.trace_sample_ratio
        if ratio >= 1.0:
            return True
        if ratio <= 0.0:
            return False
        return random.random() < ratio

    def start_span(self, name: str, *, parent: Optional[Dict[str, Any]] = None,
                   attrs: Optional[Dict[str, Any]] = None, lane: str = "",
                   start_ts: Optional[float] = None) -> Span:
        """Open a span. `parent` is a context dict (wire-shaped); when
        None the context-local current span is the parent; when there is
        no current span either, this span roots a new trace and rolls
        the sampling decision for the whole trace."""
        if parent is None:
            parent = _current.get()
        if parent is None:
            return Span(_new_id(), _new_id(), None, name, attrs=attrs,
                        lane=lane, sampled=self._sampled(),
                        start_ts=start_ts, tracer_=self)
        return Span(parent["trace_id"], _new_id(), parent["span_id"], name,
                    attrs=attrs, lane=lane,
                    sampled=bool(parent.get("sampled", True)),
                    start_ts=start_ts, tracer_=self)

    def record_span(self, name: str, start_ts: float, end_ts: float, *,
                    parent: Optional[Dict[str, Any]] = None,
                    attrs: Optional[Dict[str, Any]] = None,
                    lane: str = "", status: str = "OK") -> Span:
        """Record an already-finished interval (e.g. queue time measured
        after the fact) as one span."""
        span_ = self.start_span(name, parent=parent, attrs=attrs, lane=lane,
                                start_ts=start_ts)
        span_.end(status=status, end_ts=end_ts)
        return span_

    def _record(self, span_: Span) -> None:
        rec = span_.to_dict()
        with self._lock:
            self._buf.append(rec)
        try:
            _observe_derived(span_)
        except Exception:  # noqa: BLE001 - metrics must not break tracing
            pass

    # --------------------------------------------------------------- queries

    def spans(self, trace_id: Optional[str] = None,
              limit: int = 10_000) -> List[Dict[str, Any]]:
        with self._lock:
            out = [
                s for s in self._buf
                if trace_id is None or s["trace_id"] == trace_id
            ]
        return out[-limit:]

    def list_traces(self, limit: int = 100) -> List[Dict[str, Any]]:
        """Newest-last trace summaries: root name, span count, duration."""
        with self._lock:
            snapshot = list(self._buf)
        traces: Dict[str, Dict[str, Any]] = {}
        for s in snapshot:
            t = traces.setdefault(s["trace_id"], {
                "trace_id": s["trace_id"],
                "root": s["name"],
                "start_ts": s["start_ts"],
                "end_ts": s["end_ts"],
                "spans": 0,
                "errors": 0,
            })
            t["spans"] += 1
            t["start_ts"] = min(t["start_ts"], s["start_ts"])
            t["end_ts"] = max(t["end_ts"], s["end_ts"])
            if s["status"] != "OK":
                t["errors"] += 1
            if s["parent_id"] is None:
                t["root"] = s["name"]
        out = sorted(traces.values(), key=lambda t: t["start_ts"])
        for t in out:
            t["duration_s"] = max(0.0, t["end_ts"] - t["start_ts"])
        return out[-limit:]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def tracer() -> Tracer:
    global _tracer
    if _tracer is None:  # double-checked: creation is rare, reads are hot
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


# --------------------------------------------------------- context plumbing


def current_context() -> Optional[Dict[str, Any]]:
    """The active span's wire context, or None outside any span."""
    return _current.get()


@contextlib.contextmanager
def use_context(ctx: Optional[Dict[str, Any]]) -> Iterator[None]:
    """Adopt a propagated context (a thread hop) for the
    duration of the block; no-op when ctx is None."""
    if ctx is None:
        yield
        return
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)


# RPC methods that never carry trace context: chunk windows fire dozens
# of times per transfer (the enclosing transfer.* span already times the
# whole thing) and heartbeats/polls are pure noise.
_RPC_SKIP = frozenset({
    "pull_chunk", "push_chunk", "heartbeat", "ping", "poll_task_done",
})


def inject_context(kwargs: Dict[str, Any], method: str = "") -> Dict[str, Any]:
    """Client half of the RPC boundary: attach the current span context
    as a `_trace_ctx` kwarg (only when a sampled span is active — idle
    control traffic stays zero-overhead)."""
    ctx = _current.get()
    if ctx is None or not ctx.get("sampled", True) or method in _RPC_SKIP:
        return kwargs
    out = dict(kwargs)
    out["_trace_ctx"] = ctx
    return out


def extract_context(kwargs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Server half: pop the propagated context out of the call kwargs
    (mutates kwargs so handlers never see the private field)."""
    ctx = kwargs.pop("_trace_ctx", None)
    return ctx if isinstance(ctx, dict) and "trace_id" in ctx else None


def start_span(name: str, *, parent: Optional[Dict[str, Any]] = None,
               attrs: Optional[Dict[str, Any]] = None, lane: str = "") -> Span:
    """Module-level convenience over tracer().start_span (does NOT make
    the span current — use `span()` for that)."""
    return tracer().start_span(name, parent=parent, attrs=attrs, lane=lane)


@contextlib.contextmanager
def span(name: str, *, parent: Optional[Dict[str, Any]] = None,
         lane: str = "", **attrs: Any) -> Iterator[Span]:
    """Open a span, make it the context-local current span, end it on
    exit (status=ERROR with the exception repr on the error path)."""
    sp = tracer().start_span(name, parent=parent, attrs=attrs, lane=lane)
    token = _current.set(sp.context)
    try:
        yield sp
    except BaseException as exc:
        sp.end(status="ERROR", error=repr(exc))
        raise
    finally:
        _current.reset(token)
        sp.end()


# ------------------------------------------------------------------- export


def export_chrome_trace(spans: List[Dict[str, Any]],
                        path: Optional[str] = None,
                        extra_events: Optional[List[Dict[str, Any]]] = None,
                        ) -> str:
    """Chrome trace-event / Perfetto JSON for a span set. Spans nest by
    time on their lane: pid = the span's lane (node/actor/engine slot,
    falling back to the trace id), tid = the span name's subsystem. Load
    in https://ui.perfetto.dev or chrome://tracing.

    `extra_events` are pre-built trace events appended verbatim (a
    device trace's tracks, wall-clock aligned, so one timeline shows
    what the runtime asked for and what the card did).

    Parent→child links that CROSS a lane (a router hop landing on a
    replica, an actor call executing on the actor's thread) additionally
    emit chrome flow events (ph "s"/"f") so the causality renders as
    arrows between tracks, not just vertically stacked slices."""
    events: List[Dict[str, Any]] = list(extra_events or [])
    by_id = {s["span_id"]: s for s in spans}

    def _pid(s: Dict[str, Any]) -> str:
        return s.get("lane") or s["trace_id"][:8]

    def _tid(s: Dict[str, Any]) -> str:
        return s["name"].split(".", 1)[0]

    for s in spans:
        parent = by_id.get(s["parent_id"]) if s.get("parent_id") else None
        if parent is None or _pid(parent) == _pid(s):
            continue
        # flow id from the child span id: unique per edge, stable across
        # re-exports of the same span set
        flow_id = int(s["span_id"][:12], 16)
        events.append({
            "name": "span-link", "cat": "flow", "ph": "s", "id": flow_id,
            "ts": parent["start_ts"] * 1e6,
            "pid": _pid(parent), "tid": _tid(parent),
            "args": {"trace_id": s["trace_id"], "child": s["name"]},
        })
        events.append({
            "name": "span-link", "cat": "flow", "ph": "f", "bp": "e",
            "id": flow_id,
            "ts": max(s["start_ts"], parent["start_ts"]) * 1e6,
            "pid": _pid(s), "tid": _tid(s),
            "args": {"trace_id": s["trace_id"], "parent": parent["name"]},
        })
    for s in spans:
        end = s["end_ts"] or s["start_ts"]
        pid = s.get("lane") or s["trace_id"][:8]
        events.append({
            "name": s["name"],
            "cat": s["name"].split(".", 1)[0],
            "ph": "X",
            "ts": s["start_ts"] * 1e6,
            "dur": max(0.0, end - s["start_ts"]) * 1e6,
            "pid": pid,
            "tid": s["name"].split(".", 1)[0],
            "args": {
                "trace_id": s["trace_id"],
                "span_id": s["span_id"],
                "parent_id": s["parent_id"],
                "status": s["status"],
                **{k: v for k, v in s.get("attrs", {}).items()
                   if isinstance(v, (str, int, float, bool, type(None)))},
            },
        })
    payload = json.dumps({"traceEvents": events})
    if path:
        with open(path, "w") as f:
            f.write(payload)
    return payload


# ------------------------------------------------- device-trace bridge


def device_annotate(name: str):
    """Label a host region in torch.profiler's trace
    (`torch.profiler.record_function`), so runtime spans line up with the
    card's kernels in one capture."""
    import torch

    return torch.profiler.record_function(name)
