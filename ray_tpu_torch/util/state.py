"""State API: list/summarize the runtime's state, profiles, traces, request
and step forensics, and the chrome-trace timeline.

Port of `ray_tpu/util/state.py` for one process. JAX's queries merge this
process's rings with every node's federated tail in the control store;
these answer from this process, in a cluster too (the federation comes
with ROADMAP A6b (federation)). `head_summary` is None (no
cluster, no durability armed), `cluster_metrics` / `cluster_events` /
`cluster_logs` answer for the one local node, and `node_stats` carries
the object store and the profiling status of this process (the node stats
collector, `core/stats.py`, is ROADMAP A6b (federation)).
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional

from ..core import runtime as _rt


def _runtime():
    if not _rt.is_initialized():
        raise RuntimeError("ray_tpu_torch is not initialized")
    return _rt.get_runtime()


def list_tasks(limit: int = 1000) -> List[Dict[str, Any]]:
    """Completed task events, newest last."""
    return list(_runtime().task_events())[-limit:]


def list_actors(limit: int = 1000) -> List[Dict[str, Any]]:
    return _runtime().list_actors()[:limit]


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    store = _runtime().object_store
    with store._lock:
        entries = list(store._entries.items())[:limit]
    return [
        {
            "object_id": oid.hex(),
            "state": entry.state.name,
            "tier": entry.tier.value if entry.tier else None,
            "nbytes": entry.nbytes,
            "pin_count": entry.pin_count,
        }
        for oid, entry in entries
    ]


def list_nodes() -> List[Dict[str, Any]]:
    out = []
    for node in _runtime().scheduler.nodes():
        out.append(
            {
                "node_id": node.node_id.hex(),
                "alive": node.alive,
                "is_head": node.is_head,
                # ALIVE | PREEMPTING | DEAD: a PREEMPTING node announced its
                # death and takes no new placements
                "state": ("PREEMPTING" if node.alive and node.draining
                          else ("ALIVE" if node.alive else "DEAD")),
                "draining": bool(node.draining),
                "drain_reason": node.drain_reason,
                "drain_deadline": node.drain_deadline,
                "resources_total": dict(node.resources.total),
                "resources_available": dict(node.resources.available()),
            }
        )
    return out


def list_placement_groups() -> List[Dict[str, Any]]:
    """The placement groups this process owns, with their state machine's
    fields: state (PENDING, RESERVED, RESCHEDULING, FAILED), the budget
    used, the death history and each bundle's node. In a cluster the same
    records sit in the GCS table `PG_NS` (`GcsClient.pg_state`)."""
    out = []
    for pg in _runtime().scheduler.placement_groups():
        out.append({
            "pg_id": pg.id.hex(),
            "name": pg.name,
            "strategy": pg.strategy.value,
            "state": pg.state,
            "max_reschedules": pg.max_reschedules,
            "reschedules_used": pg.reschedules_used,
            "death_history": list(pg.death_history),
            "failure_reason": pg.failure_reason,
            "bundles": [{"index": b.index, "resources": dict(b.resources),
                         "node": b.node.node_id.hex() if b.node is not None else None}
                        for b in pg.bundles],
        })
    return out


def node_stats() -> Dict[str, Dict[str, Any]]:
    """This process's snapshot, keyed by the head node's id hex: the
    object store's usage and the profiling status."""
    from . import profiling

    runtime = _runtime()
    local_hex = runtime.scheduler.head_node().node_id.hex()
    return {local_hex: {
        "ts": time.time(),
        "object_store": runtime.object_store.usage(),
        "profiling": profiling.node_snapshot(),
    }}


def summary() -> Dict[str, Any]:
    runtime = _runtime()
    events = runtime.task_events()
    return {
        "nodes": len(list_nodes()),
        "actors": len(runtime.list_actors()),
        "tasks_finished": sum(1 for e in events if e["ok"]),
        "tasks_failed": sum(1 for e in events if not e["ok"]),
        "object_store": runtime.object_store.usage(),
        "scheduler": dict(runtime.scheduler.stats),
        "autoscaler": None,  # no capacity autoscaler runs in one process
        "node_stats": node_stats(),
    }


def head_summary() -> Optional[Dict[str, Any]]:
    """Head fault-tolerance health. None: one process, no cluster and no
    durability armed (JAX's answer in the same case)."""
    _runtime()
    return None


def cluster_metrics(raw: bool = False):
    """Cluster metrics. Default: ONE merged Prometheus exposition where
    every sample carries a `node_id` label (what /metrics/cluster serves).
    `raw=True`: the unmerged per-node expositions keyed by node id hex —
    here the one local node's."""
    from .metrics import cluster_prometheus_text, registry

    if not raw:
        return cluster_prometheus_text()
    local_hex = _runtime().scheduler.head_node().node_id.hex()
    return {local_hex: registry().prometheus_text()}


def _fmt_bytes(n: float) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def status_report(verbose: bool = False) -> str:
    """`ray status`-style summary: nodes with usage, this process's
    snapshot, actors, placement groups, object-store totals, and recent
    warnings."""
    runtime = _runtime()
    nodes = list_nodes()
    stats = node_stats()
    s = summary()
    lines: List[str] = []
    lines.append("======== ray_tpu_torch status ========")
    lines.append(time.strftime("%Y-%m-%d %H:%M:%S"))
    by_state: Dict[str, int] = {}
    for n in nodes:
        by_state[n["state"]] = by_state.get(n["state"], 0) + 1
    lines.append("")
    lines.append(
        f"Nodes: {len(nodes)} ("
        + ", ".join(f"{v} {k}" for k, v in sorted(by_state.items()))
        + ")"
    )
    for n in nodes:
        head = " head" if n["is_head"] else ""
        lines.append(f"  node {n['node_id'][:12]} {n['state']}{head}")
        total = n["resources_total"]
        avail = n["resources_available"]
        usage = ", ".join(
            f"{k}: {total.get(k, 0.0) - avail.get(k, 0.0):g}/{total.get(k, 0.0):g} used"
            for k in sorted(total)
        )
        lines.append(f"    resources: {usage or '(none)'}")
        snap = stats.get(n["node_id"])
        if snap:
            store = snap.get("object_store", {})
            lines.append(
                f"    object store: {_fmt_bytes(store.get('host_bytes', 0))} host, "
                f"{_fmt_bytes(store.get('device_bytes', 0))} device"
                f" in {store.get('num_objects', 0)} object(s)"
            )
            prof = snap.get("profiling") or {}
            if verbose and prof:
                parts = ["profiler: server not available (torch.profiler has none)"]
                if prof.get("active_capture"):
                    parts.append(f"capturing {prof['active_capture']}")
                last = prof.get("last_capture")
                if last:
                    parts.append(
                        f"last capture {last.get('profile_id') or '(local)'} "
                        f"{last.get('duration_s', 0.0):.1f}s "
                        f"{_fmt_bytes(last.get('bytes', 0))}"
                    )
                lines.append("    " + "; ".join(parts))
    actors = runtime.list_actors()
    actor_states: Dict[str, int] = {}
    for a in actors:
        actor_states[a["state"]] = actor_states.get(a["state"], 0) + 1
    lines.append("")
    lines.append(
        f"Actors: {len(actors)}"
        + (" (" + ", ".join(f"{k}={v}" for k, v in sorted(actor_states.items())) + ")"
           if actors else "")
    )
    pgs = list(getattr(runtime.scheduler, "_placement_groups", {}).values())
    pg_states: Dict[str, int] = {}
    for pg in pgs:
        pg_states[pg.state] = pg_states.get(pg.state, 0) + 1
    lines.append(
        f"Placement groups: {len(pgs)}"
        + (" (" + ", ".join(f"{k}={v}" for k, v in sorted(pg_states.items())) + ")"
           if pgs else "")
    )
    store = s["object_store"]
    lines.append(
        f"Object store: {_fmt_bytes(store.get('host_bytes', 0))} host"
        f" / {store.get('num_objects', 0)} object(s)"
    )
    sched = s["scheduler"]
    lines.append(
        "Scheduler: " + " ".join(f"{k}={v}" for k, v in sorted(sched.items()))
    )
    warn = [
        e for e in list_events(limit=200)
        if e["severity"] in ("WARNING", "ERROR")
    ][-8:]
    lines.append("")
    lines.append(f"Recent warnings ({len(warn)}):")
    for e in warn:
        ts = time.strftime("%H:%M:%S", time.localtime(e.get("ts", 0)))
        lines.append(f"  {ts} {e['severity']:7s} [{e['source']}] {e['message']}")
    if not warn:
        lines.append("  (none)")
    if verbose:
        lines.append("")
        lines.append("Logs (per node):")
        for node_hex, tail in cluster_logs(tail=20).items():
            lines.append(f"  --- node {node_hex[:12]} ---")
            for line in tail:
                lines.append(f"  {line}")
    return "\n".join(lines)


def profile(nodes: Optional[List[str]] = None,
            duration_s: Optional[float] = None,
            device: bool = True, host: bool = True) -> Dict[str, Any]:
    """Run a profile capture (device trace + host sampling profile) over
    the selected logical nodes (hex prefixes; None = all) and register
    it; returns the capture record."""
    return _runtime().profile_capture(
        nodes=nodes, duration_s=duration_s, device=device, host=host
    )


def list_profiles() -> List[Dict[str, Any]]:
    """Registered capture records, newest last: the runtime's profile store
    plus any record in the control store's `_profiles` table."""
    from ..core.gcs import PROFILE_NS

    runtime = _runtime()
    records = {r["profile_id"]: r for r in runtime.profiles.list()}
    for key in runtime.gcs.kv.keys(namespace=PROFILE_NS):
        rec = runtime.gcs.kv.get(key, namespace=PROFILE_NS)
        if rec:
            records.setdefault(key, rec)
    return sorted(records.values(), key=lambda r: r.get("started_at", 0.0))


def get_profile(profile_id: str) -> Dict[str, Any]:
    """One capture's record: per-node status, artifact names, sizes."""
    for rec in list_profiles():
        if rec.get("profile_id") == profile_id:
            return rec
    raise ValueError(f"no registered profile {profile_id!r}")


def profile_artifact(profile_id: str, node_hex: str, name: str) -> bytes:
    """Raw bytes of one captured artifact."""
    data = _runtime().profiles.artifact(profile_id, node_hex, name)
    if data is None:
        raise ValueError(
            f"no artifact {name!r} for node {node_hex[:12]} in profile "
            f"{profile_id!r}"
        )
    return data


def list_traces(limit: int = 100) -> List[Dict[str, Any]]:
    """Trace summaries of THIS process's tracer (newest last): trace_id,
    root span name, span count, wall duration. Works without a live
    runtime — the tracer is per-process."""
    from .tracing import tracer

    return tracer().list_traces(limit=limit)


def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """Every span of one trace, sorted by start time."""
    from .tracing import tracer

    return sorted(tracer().spans(trace_id), key=lambda s: s["start_ts"])


def trace_dump(path: Optional[str] = None,
               trace_id: Optional[str] = None,
               profile_id: Optional[str] = None) -> str:
    """Perfetto/chrome-trace JSON of runtime SPANS (util/tracing): spans
    nest, one lane per node/actor/engine slot. `profile_id` names a
    registered capture (`profile`): its device-trace events merge in as
    per-device tracks, wall-clock aligned with the runtime spans — one
    file shows what the runtime asked for and what the card did during
    it."""
    from .tracing import export_chrome_trace, tracer

    if trace_id is not None:
        spans = get_trace(trace_id)
    else:
        spans = sorted(tracer().spans(), key=lambda s: s["start_ts"])
    extra = _device_trace_events(profile_id) if profile_id else None
    return export_chrome_trace(spans, path, extra_events=extra)


def _device_trace_events(profile_id: str):
    """Load a registered capture's device-trace events for the Perfetto
    merge: one `device:<node>` lane set per captured node."""
    from . import profiling

    store = _runtime().profiles
    record = store.get(profile_id)
    if record is None:
        raise ValueError(f"no registered profile {profile_id!r}")
    events = []
    for node_hex, meta in record.get("nodes", {}).items():
        if meta.get("artifacts_at"):
            continue  # logical-node alias: artifacts live under the head
        artifacts = {
            name.split("/", 1)[1]: data
            for name, data in store.artifacts_for(profile_id, node_hex=node_hex).items()
        }
        if not artifacts:
            continue
        events.extend(profiling.load_device_trace_events(
            artifacts,
            started_at=meta.get("started_at", record["started_at"]),
            lane_prefix=f"device:{node_hex[:8]}",
        ))
    return events


# one-shot latch for the chrome_tracing_dump deprecation warning
# (a list so tests can reset it without reaching into module globals)
_chrome_dump_warned = [False]


def chrome_tracing_dump(path: Optional[str] = None) -> str:
    """DEPRECATED: thin wrapper over `trace_dump` (one chrome-trace
    encoder). Emits one DeprecationWarning per process."""
    if not _chrome_dump_warned[0]:
        _chrome_dump_warned[0] = True
        warnings.warn(
            "chrome_tracing_dump is deprecated; use trace_dump (same "
            "chrome-trace JSON, full span causality)",
            DeprecationWarning, stacklevel=2,
        )
    return trace_dump(path)


def list_events(limit: int = 500, severity: Optional[str] = None,
                source: Optional[str] = None) -> List[Dict[str, Any]]:
    """Structured runtime events of THIS process (util/events.py)."""
    from .events import events as _events

    return _events().list(limit=limit, severity=severity, source=source)


def events(limit: int = 1000, *, kind: Optional[str] = None,
           node: Optional[str] = None, since: float = 0.0,
           severity: Optional[str] = None,
           source: Optional[str] = None) -> List[Dict[str, Any]]:
    """The flight-recorder tail, sorted by wall time: this process's
    event ring. Filters: `kind` (registered event kind), `node` (id hex
    prefix), `since` (wall ts), `severity` (case-insensitive), `source`."""
    from .events import events as _events
    from .events import normalize_severity

    sev = normalize_severity(severity) if severity is not None else None
    out = [
        e for e in _events().list(limit=10_000)
        if e.get("ts", 0.0) >= since
        and (kind is None or e.get("kind") == kind)
        and (node is None or str(e.get("node") or "").startswith(node))
        and (sev is None or e.get("severity") == sev)
        and (source is None or e.get("source") == source)
    ]
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return out[-limit:] if limit else out


def _request_marks() -> List[Dict[str, Any]]:
    """Every request-forensics mark of this process's reqlog ring, sorted
    by wall time."""
    from ..serve import reqlog

    out = list(reqlog.log().since(0, max_n=1_000_000))
    out.sort(key=lambda m: (m.get("ts", 0.0), m.get("seq", 0)))
    return out


def request_timeline(request_id: str) -> List[Dict[str, Any]]:
    """Every recorded mark of ONE request in causal (wall-clock) order:
    the router's marks interleaved with the engine's on the shared
    request id. Render with `serve.reqlog.render_waterfall(marks)`."""
    return [m for m in _request_marks() if m.get("rid") == request_id]


def list_requests(tenant: Optional[str] = None, slow_only: bool = False,
                  limit: int = 200) -> List[Dict[str, Any]]:
    """Request summaries (newest last): request id, tenant, first/last
    phase, terminal outcome, TTFT and its decomposition buckets.
    `slow_only` keeps requests whose TTFT exceeded the serve objective or
    that timed out — the on-call's worklist."""
    from ..core.config import cfg
    from ..serve import reqlog

    merged: Dict[str, Dict[str, Any]] = {
        s["request_id"]: s for s in reqlog.summarize_marks(_request_marks())
    }
    # the summary index survives mark-ring eviction: it wins over a
    # summary rebuilt from a truncated ring
    for s in reqlog.log().requests(limit=1_000_000):
        merged[s["request_id"]] = s
    out = list(merged.values())
    if tenant is not None:
        out = [s for s in out if s.get("tenant") == tenant]
    if slow_only:
        slo = cfg.serve_slo_ttft_p99_s
        out = [
            s for s in out
            if (s.get("ttft_s") is not None and s["ttft_s"] > slo)
            or s.get("terminal") in ("route.timeout", "engine.timeout")
        ]
    out.sort(key=lambda s: (s.get("last_ts", 0.0), s.get("request_id", "")))
    return out[-limit:] if limit else out


def _step_marks() -> List[Dict[str, Any]]:
    """Every training-forensics step mark of this process's steplog ring,
    deduped by (run, rank, step, phase) and sorted by wall time."""
    from ..train import steplog

    merged: Dict[Any, Dict[str, Any]] = {}
    for m in steplog.log().since(0, max_n=1_000_000):
        merged[(m.get("run"), m.get("rank"), m.get("step"), m.get("phase"))] = m
    out = list(merged.values())
    out.sort(key=lambda m: (m.get("ts", 0.0), m.get("seq", 0)))
    return out


def step_timeline(run: str, rank: Optional[int] = None) -> List[Dict[str, Any]]:
    """Per-rank step-phase summaries of ONE training run (sampled steps
    only), ordered by (step, rank). Each summary's buckets sum to its
    step wall time — render with `train.steplog.render_waterfall`."""
    from ..train import steplog

    out = [
        s for s in steplog.summarize_steps(_step_marks())
        if s.get("run") == run and (rank is None or s.get("rank") == rank)
    ]
    out.sort(key=lambda s: (s.get("step", 0), s.get("rank", 0)))
    return out


def list_steps(run: Optional[str] = None,
               limit: int = 200) -> List[Dict[str, Any]]:
    """Sampled-step summaries (newest last): run, rank, step, wall
    seconds, phase buckets. The summary index survives mark-ring
    eviction, so it wins over a summary rebuilt from the ring."""
    from ..train import steplog

    merged: Dict[Any, Dict[str, Any]] = {
        (s.get("run"), s.get("rank"), s.get("step")): s
        for s in steplog.summarize_steps(_step_marks())
    }
    for s in steplog.log().steps(run=run, limit=1_000_000):
        merged[(s.get("run"), s.get("rank"), s.get("step"))] = s
    out = list(merged.values())
    if run is not None:
        out = [s for s in out if s.get("run") == run]
    out.sort(key=lambda s: (s.get("ts", 0.0), s.get("step", 0), s.get("rank", 0)))
    return out[-limit:] if limit else out


def step_skew(run: str) -> List[Dict[str, Any]]:
    """Cross-rank skew matrix of one run's sampled steps
    (`train.steplog.skew_matrix`)."""
    from ..train import steplog

    return steplog.skew_matrix(step_timeline(run))


def engine_snapshot() -> Dict[str, Any]:
    """Live introspection of every LLM engine in THIS process, keyed by
    engine label: lane table (who holds each lane, position, pages,
    in-flight blocks), page-pool occupancy, prefix-cache chain heads, and
    per-tenant fair-queue depths. Point-in-time and lock-free on the
    engine side — a forensics read never stalls the serving loop."""
    from ..serve.llm import engine as llm_engine

    out: Dict[str, Any] = {}
    for label, eng in list(llm_engine._ENGINES.items()):
        try:
            out[label] = eng.snapshot()
        except Exception as e:  # noqa: BLE001 - one bad engine ≠ no answer
            out[label] = {"error": repr(e)}
    return out


def postmortem(output: str, note: str = "") -> Dict[str, Any]:
    """Snapshot the observability planes — events, span buffers,
    /metrics/cluster, node stats, profile metas — into one postmortem
    bundle archive at `output`, including the reconstructed
    wall-clock-aligned Perfetto timeline. Returns the bundle manifest."""
    from .postmortem import build_bundle

    return build_bundle(output, note=note)


def cluster_events(limit: int = 500) -> Dict[str, List[Dict[str, Any]]]:
    """Event tails for every node: here the one local node's."""
    _runtime()
    return {"local": list_events(limit=limit)}


def cluster_logs(tail: int = 200) -> Dict[str, List[str]]:
    """Log tails for every node: here the one local node's."""
    from . import logs

    _runtime()
    return {"local": logs.tail(tail)}
