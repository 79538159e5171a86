"""Request forensics plane: per-request lifecycle ledger.

Port of `ray_tpu/serve/reqlog.py`. The RequestLog records typed PHASE
MARKS with both clocks (wall for placement across processes, mono for
interval math) along the request path: HTTP receive → router receive →
fair-queue park/grant → replica dispatch (incl. failover hops) → engine
phases → finish/shed/timeout. Marks live in a bounded ring plus a
bounded per-request summary index; the shared request id also lands on
the trace spans, joining the two views.

The HTTP frontends, the router and both engines mark their phases
(`serve/llm/engine.py`, `paged_engine.py`). The cluster heartbeat
federates each node's tail into the GCS ``_requests`` table
(core/cluster.py, the same piggyback as the flight recorder), so
`util/state.py` answers `request_timeline` / `list_requests` cluster-wide.

Phases are TYPED: every ``mark`` names a phase registered in ``PHASES``,
so the waterfall renderer and the TTFT decomposition can rely on phase
names instead of parsing messages.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

# ----------------------------------------------------------- phase registry
#
# phase -> one-line doc. Components may register additional phases at
# import time with register_phase.

PHASES: Dict[str, str] = {
    # HTTP frontends (openai.py, serve/api.py)
    "http.received": "an HTTP frontend accepted the request",
    # router (serve/router.py)
    "route.received": "the request entered the router via a handle",
    "route.shed": "the router shed the request (parked-queue bound)",
    "route.parked": "no replica had capacity; parked in the fair queue",
    "route.granted": "the fair queue granted the parked request a slot",
    "route.dispatched": "the router dispatched the call to a replica",
    "route.failover": "the router re-dispatched after a replica failure",
    "route.timeout": "the request deadline expired inside the router",
    "route.failed": "the router sealed a non-retryable failure",
    # engine admission (llm/engine.py, llm/paged_engine.py)
    "engine.submitted": "the engine accepted the request into its queue",
    "engine.shed": "engine admission control shed the request",
    "engine.timeout": "the request deadline expired inside the engine",
    "engine.admitted": "the request was seated in an engine lane",
    "engine.page_stall": "admission stalled waiting for KV pages",
    # engine execution (llm/paged_engine.py)
    "engine.prefill_chunk": "one prompt chunk was ingested",
    "engine.first_token": "the first token was emitted (TTFT point)",
    "engine.decode_block": "a fused decode block completed",
    "engine.spec_round": "a speculative verify round completed",
    "engine.cow": "a copy-on-write page copy before divergence",
    "engine.preempted": "the lane was parked for a higher-priority lane",
    "engine.resumed": "a parked lane was re-admitted",
    "engine.finished": "the request finished and emitted its last token",
}

# Phases that END a request: once one is recorded, the request is no
# longer pending (shed/expired requests must never appear
# forever-pending in list_requests()).
TERMINAL_PHASES = frozenset({
    "route.shed", "route.timeout", "route.failed",
    "engine.shed", "engine.timeout", "engine.finished",
})


def register_phase(phase: str, doc: str = "") -> None:
    """Register an additional typed request phase (idempotent)."""
    PHASES.setdefault(phase, doc)


def request_phases() -> Dict[str, str]:
    """The registered phase catalog (copy)."""
    return dict(PHASES)


def new_request_id() -> str:
    """A fresh end-to-end request id (the public key threaded
    frontend→router→replica→engine and echoed in responses)."""
    return "req-" + uuid.uuid4().hex[:16]


def _default_node() -> Optional[str]:
    from ..util import logs

    return logs._node_hex


class RequestLog:
    """Per-process request recorder: a bounded mark ring plus a bounded
    per-request summary index (OrderedDict, oldest-evicted-first)."""

    def __init__(self, mark_capacity: int = 4096,
                 request_capacity: int = 1024):
        self._marks: "deque[Dict[str, Any]]" = deque(maxlen=mark_capacity)
        self._requests: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._request_capacity = request_capacity
        self._lock = threading.Lock()
        self._seq = 0

    def mark(self, request_id: str, phase: str,
             node: Optional[str] = None,
             tenant: Optional[str] = None,
             **attrs: Any) -> Dict[str, Any]:
        """Record one typed phase mark. `phase` is a registered PHASES
        name (unknown phases are still recorded)."""
        if node is None:
            node = _default_node()
        with self._lock:
            self._seq += 1
            rec: Dict[str, Any] = {
                "seq": self._seq,
                "rid": request_id,
                "phase": phase,
                "ts": time.time(),
                "mono": time.perf_counter(),
                "node": node,
            }
            if tenant is not None:
                rec["tenant"] = tenant
            if attrs:
                rec["attrs"] = attrs
            self._marks.append(rec)
            self._index_locked(rec)
        return rec

    def _index_locked(self, rec: Dict[str, Any]) -> None:
        rid = rec["rid"]
        summary = self._requests.get(rid)
        if summary is None:
            summary = {
                "request_id": rid,
                "tenant": rec.get("tenant"),
                "node": rec.get("node"),
                "first_ts": rec["ts"],
                "last_ts": rec["ts"],
                "first_phase": rec["phase"],
                "last_phase": rec["phase"],
                "marks": 0,
                "terminal": None,
                "ttft_s": None,
            }
            self._requests[rid] = summary
            while len(self._requests) > self._request_capacity:
                self._requests.popitem(last=False)
        summary["marks"] += 1
        summary["last_ts"] = rec["ts"]
        summary["last_phase"] = rec["phase"]
        if rec.get("tenant") is not None:
            summary["tenant"] = rec["tenant"]
        # first terminal wins: a late straggler mark must not resurrect
        # a shed/timed-out request into a different outcome
        if rec["phase"] in TERMINAL_PHASES and summary["terminal"] is None:
            summary["terminal"] = rec["phase"]
        if rec["phase"] == "engine.first_token":
            attrs = rec.get("attrs") or {}
            summary["ttft_s"] = attrs.get("ttft_s")
            summary["buckets"] = {
                k: attrs[k]
                for k in ("queue_wait_s", "preempt_wait_s",
                          "prefill_compute_s", "cache_saved_s")
                if k in attrs
            }

    # --------------------------------------------------------------- queries

    def timeline(self, request_id: str) -> List[Dict[str, Any]]:
        """Every buffered mark of one request, oldest first."""
        with self._lock:
            return [m for m in self._marks if m["rid"] == request_id]

    def requests(self, tenant: Optional[str] = None,
                 slow_only: bool = False,
                 limit: int = 200) -> List[Dict[str, Any]]:
        """Request summaries, newest last. `slow_only` keeps requests
        whose TTFT exceeded the serve SLO objective or that timed out."""
        from ..core.config import cfg

        slo = cfg.serve_slo_ttft_p99_s
        with self._lock:
            out = [dict(s) for s in self._requests.values()]
        if tenant is not None:
            out = [s for s in out if s.get("tenant") == tenant]
        if slow_only:
            out = [
                s for s in out
                if (s.get("ttft_s") is not None and s["ttft_s"] > slo)
                or s.get("terminal") in ("route.timeout", "engine.timeout")
            ]
        return out[-limit:]

    def since(self, seq: int, max_n: int = 1000) -> List[Dict[str, Any]]:
        """The OLDEST max_n marks with seq greater than `seq` (a cursor
        walk, same contract as EventLog.since)."""
        with self._lock:
            return [m for m in self._marks if m["seq"] > seq][:max_n]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seq": self._seq,
                "buffered_marks": len(self._marks),
                "indexed_requests": len(self._requests),
            }

    def clear(self) -> None:
        with self._lock:
            self._marks.clear()
            self._requests.clear()


# ------------------------------------------------------- module singleton

_reqlog: Optional[RequestLog] = None
_reqlog_lock = threading.Lock()


def log() -> RequestLog:
    global _reqlog
    with _reqlog_lock:
        if _reqlog is None:
            from ..core.config import cfg

            _reqlog = RequestLog(
                mark_capacity=cfg.serve_request_log_marks,
                request_capacity=cfg.serve_request_log_requests,
            )
        return _reqlog


def enabled() -> bool:
    from ..core.config import cfg

    return bool(cfg.serve_request_log)


def mark(request_id: Optional[str], phase: str,
         tenant: Optional[str] = None, **attrs: Any) -> None:
    """Fast-path module-level mark: no-op when the request has no id
    (recorder off at ingress) or the recorder is disabled."""
    if request_id is None or not enabled():
        return
    log().mark(request_id, phase, tenant=tenant, **attrs)


# ------------------------------------------------------- derived views


def summarize_marks(marks: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Build request summaries from a flat mark list (marks gathered
    without their summary index)."""
    scratch = RequestLog(mark_capacity=len(marks) + 1,
                         request_capacity=len(marks) + 1)
    with scratch._lock:
        for m in sorted(marks, key=lambda m: (m.get("ts", 0.0),
                                              m.get("seq", 0))):
            scratch._index_locked(m)
        return [dict(s) for s in scratch._requests.values()]


def decompose(marks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """TTFT decomposition of one request's timeline: the bucket attrs
    the engine attached at the first-token mark (queue_wait +
    preempt_wait + prefill_compute sum to the measured TTFT by
    construction; cache_saved is the informational estimate of what the
    prefix cache skipped, NOT part of the sum)."""
    for m in marks:
        if m.get("phase") == "engine.first_token":
            attrs = dict(m.get("attrs") or {})
            return attrs
    return {}


def render_waterfall(marks: List[Dict[str, Any]]) -> str:
    """Causally-ordered text waterfall of one request's marks: relative
    wall-clock offsets, per-mark attrs, and the TTFT decomposition
    footer. Marks from several nodes interleave on wall time."""
    if not marks:
        return "(no marks)"
    marks = sorted(marks, key=lambda m: (m.get("ts", 0.0), m.get("seq", 0)))
    rid = marks[0].get("rid", "?")
    tenant = next((m["tenant"] for m in marks if m.get("tenant")), None)
    t0 = marks[0].get("ts", 0.0)
    span = max(m.get("ts", t0) for m in marks) - t0
    lines = [
        f"request {rid}"
        + (f" · tenant {tenant}" if tenant else "")
        + f" · {len(marks)} mark(s) · {span:.3f}s"
    ]
    width = 28
    for m in marks:
        off = m.get("ts", t0) - t0
        bar_at = 0 if span <= 0 else int((off / span) * (width - 1))
        bar = " " * bar_at + "|"
        node = str(m.get("node") or "")[:8]
        attrs = m.get("attrs") or {}
        attr_txt = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in attrs.items()
        )
        lines.append(
            f"  +{off:9.4f}s {bar:<{width}} {m['phase']:<21}"
            f" {node:<8} {attr_txt}".rstrip()
        )
    d = decompose(marks)
    if d.get("ttft_s") is not None:
        parts = " + ".join(
            f"{k[:-2]} {d.get(k, 0.0):.4f}"
            for k in ("queue_wait_s", "preempt_wait_s", "prefill_compute_s")
        )
        cache = (
            f" (cache_saved ~{d['cache_saved_s']:.4f}s,"
            f" cached_tokens {d.get('cached_tokens', 0)})"
            if d.get("cache_saved_s") else ""
        )
        lines.append(f"  TTFT {d['ttft_s']:.4f}s = {parts}{cache}")
    terminal = next(
        (m["phase"] for m in marks if m["phase"] in TERMINAL_PHASES), None
    )
    if terminal:
        lines.append(f"  terminal: {terminal}")
    return "\n".join(lines)
