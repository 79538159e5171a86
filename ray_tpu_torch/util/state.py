"""State API: list/summarize the runtime's state, profiles, traces, request
and step forensics, and the chrome-trace timeline.

Port of `ray_tpu/util/state.py`. The queries merge this process's rings
with every node's federated tail in the control store (the `_events`,
`_requests` and `_steps` tables the cluster heartbeat fills,
`core/cluster.py`), and the span, log, event and metrics queries fan out
to every node agent (`ClusterContext.fanout_nodes`). `node_stats` carries
this process's collector (`core/stats.py`) and every member's snapshot
from the GCS node table; `head_summary` reports the head's durability
(epoch, WAL, snapshot, restore, reconciliation) and each node's
buffered-federation depth; `autoscaler_summary` reports the running
capacity autoscaler (`core/capacity.py`), and the summary and the status
report carry the scheduler's pending demand.
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
    """Per-node telemetry snapshots, keyed by node id hex: this process's
    collector live, plus every cluster member's latest
    heartbeat-piggybacked snapshot from the GCS node table."""
    runtime = _runtime()
    local_hex = runtime.scheduler.head_node().node_id.hex()
    out: Dict[str, Dict[str, Any]] = {}
    collector = getattr(runtime, "node_stats", None)
    if collector is not None:
        out[local_hex] = collector.snapshot()
    ctx = getattr(runtime, "cluster", None)
    if ctx is not None:
        for info in ctx.nodes():
            stats = info.get("stats")
            if stats and info.get("node_id") not in out:
                out[info["node_id"]] = stats
    return out


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
        "pending_tasks": len(runtime.scheduler.pending_task_demand()),
        "pending_demand": len(runtime.scheduler.pending_demand()),
        "autoscaler": autoscaler_summary(),
        "node_stats": node_stats(),
    }


def head_summary() -> Optional[Dict[str, Any]]:
    """Head fault-tolerance health: cluster epoch, WAL size and seq, last
    snapshot time, restore / reconcile provenance, plus each node's
    buffered-federation depth (how many events / marks wait to ship:
    grows during a head outage, drains after reconnect). None when
    nothing durability-related is on (no WAL, no cluster)."""
    runtime = _runtime()
    ctx = getattr(runtime, "cluster", None)
    out: Dict[str, Any]
    if ctx is None or getattr(ctx, "is_head", False):
        gcs = runtime.gcs
        out = {
            "epoch": gcs.current_epoch(),
            "wal": gcs.wal_stats(),
            "last_snapshot_ts": gcs.last_snapshot_ts,
            "restore": dict(gcs.last_restore),
            "reconcile": dict(getattr(runtime, "_reconcile_state", {})),
        }
        if ctx is None and out["wal"] is None and not out["epoch"]:
            return None  # one process, no durability armed
    else:
        try:
            out = ctx.gcs.head_info()
        except Exception:  # noqa: BLE001 - degraded mode is a valid answer
            return {"unreachable_s": round(ctx.gcs.outage_s(), 2)}
    if ctx is not None:
        lag = {}
        for info in ctx.nodes():
            depth = info.get("federation_lag")
            if depth:
                lag[info["node_id"]] = depth
        if lag:
            out["federation_lag"] = lag
        out["head_outage_s"] = round(ctx.gcs.outage_s(), 2)
    return out


def autoscaler_summary() -> Optional[Dict[str, Any]]:
    """status() of the running capacity autoscaler, or None when none
    runs in this process."""
    from ..core.capacity import active_autoscaler

    scaler = active_autoscaler()
    return scaler.status() if scaler is not None else None


def cluster_metrics(raw: bool = False):
    """Cluster metrics. Default: ONE merged Prometheus exposition where
    every sample carries a `node_id` label (what /metrics/cluster serves).
    `raw=True`: the unmerged per-node expositions keyed by node id hex."""
    from .metrics import cluster_prometheus_text, registry

    if not raw:
        return cluster_prometheus_text()
    runtime = _runtime()
    ctx = getattr(runtime, "cluster", None)
    local_hex = runtime.scheduler.head_node().node_id.hex()
    parts = {local_hex: registry().prometheus_text()}
    if ctx is not None:
        for node_hex, text in ctx.fanout_nodes("metrics_snapshot",
                                               placeholder=lambda e: None).items():
            if text:
                parts[node_hex] = text
    return parts


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
    task_demand = runtime.scheduler.pending_task_demand()
    gang_demand = runtime.scheduler.pending_gang_demand()
    lines.append("")
    if task_demand:
        lines.append(f"Pending tasks: {len(task_demand)} (demand: {task_demand[:8]}"
                     f"{'...' if len(task_demand) > 8 else ''})")
    else:
        lines.append("Pending tasks: 0")
    if gang_demand:
        lines.append(f"Pending gang demand: {len(gang_demand)} group(s)")
        for gang in gang_demand[:4]:
            lines.append(f"  pg {gang['pg'][:12]} [{gang['state']}] {gang['name'] or ''}: "
                         f"{len(gang['bundles'])} bundle(s) unplaced")
    scaler = s["autoscaler"]
    if scaler is not None:
        classes = ", ".join(f"{k}={v}" for k, v in sorted(scaler["per_class"].items()))
        lines.append(
            f"Autoscaler: {scaler['managed_nodes']} managed node(s) ({classes or 'none'}), "
            f"{scaler['retiring']} retiring, {scaler['pending_demands']} pending demand(s), "
            f"ups={scaler['scale_ups']} downs={scaler['scale_downs']} "
            f"replacements={scaler['replacements']} blocked={scaler['blocked']}")
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


def _node_spans(spans: Dict[str, Dict[str, Any]], trace_id: Optional[str]) -> None:
    """Add every cluster node's completed spans (of `trace_id`, or all)
    to `spans`, keyed by span id (the node_spans RPC)."""
    if not _rt.is_initialized():
        return
    ctx = getattr(_rt.get_runtime(), "cluster", None)
    if ctx is None:
        return
    fanned = ctx.fanout_nodes("node_spans", trace_id, 10_000, placeholder=lambda e: [])
    for node_spans in fanned.values():
        for s in node_spans or []:
            spans.setdefault(s["span_id"], s)


def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """Every span of one trace, stitched cluster-wide: the local ring plus
    each node agent's (node_spans RPC), sorted by start time. A remote
    task's spans live on the agent that ran it."""
    from .tracing import tracer

    spans = {s["span_id"]: s for s in tracer().spans(trace_id)}
    _node_spans(spans, trace_id)
    return sorted(spans.values(), key=lambda s: s["start_ts"])


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
        by_id = {s["span_id"]: s for s in tracer().spans()}
        _node_spans(by_id, None)
        spans = sorted(by_id.values(), key=lambda s: s["start_ts"])
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
    """The cluster-wide flight-recorder tail, sorted by wall time: this
    process's event ring merged with every node's federated tail from the
    GCS `_events` table. Filters: `kind` (registered event kind), `node`
    (id hex prefix), `since` (wall ts), `severity` (case-insensitive),
    `source`. Deduped by (node, seq): the head's own events appear both
    locally and in the table."""
    from ..core.gcs import EVENT_NS
    from .events import events as _events
    from .events import normalize_severity

    merged: Dict[Any, Dict[str, Any]] = {}
    for e in _events().list(limit=10_000):
        merged[(e.get("node"), e["seq"])] = e
    for e in _federated(EVENT_NS):
        merged.setdefault((e.get("node"), e.get("seq")), e)
    sev = normalize_severity(severity) if severity is not None else None
    out = [
        e for e in merged.values()
        if e.get("ts", 0.0) >= since
        and (kind is None or e.get("kind") == kind)
        and (node is None or str(e.get("node") or "").startswith(node))
        and (sev is None or e.get("severity") == sev)
        and (source is None or e.get("source") == source)
    ]
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return out[-limit:] if limit else out


def _federated(namespace: str) -> List[Dict[str, Any]]:
    """Every record of one federated table (`_events`, `_requests`,
    `_steps`), all nodes' keys in turn: through the GCS client in a
    cluster, from this process's control store without one. Empty when
    the head does not answer: the local ring still does."""
    if not _rt.is_initialized():
        return []
    runtime = _rt.get_runtime()
    ctx = getattr(runtime, "cluster", None)
    out: List[Dict[str, Any]] = []
    try:
        if ctx is not None:
            for key in ctx.gcs.kv_keys(namespace=namespace):
                out.extend(ctx.gcs.kv_get(key, namespace=namespace) or [])
        else:
            kv = runtime.gcs.kv
            for key in kv.keys(namespace=namespace):
                out.extend(kv.get(key, namespace=namespace) or [])
    except Exception:  # noqa: BLE001 - the local ring still answers
        pass
    return out


def _federated_request_marks() -> List[Dict[str, Any]]:
    """Every request-forensics mark visible from this process: the local
    reqlog ring merged with every node's federated tail in the GCS
    `_requests` table. Deduped by (node, seq), sorted by wall time."""
    from ..core.gcs import REQLOG_NS
    from ..serve import reqlog

    merged: Dict[Any, Dict[str, Any]] = {}
    for m in reqlog.log().since(0, max_n=1_000_000):
        merged[(m.get("node"), m.get("seq"))] = m
    for m in _federated(REQLOG_NS):
        merged.setdefault((m.get("node"), m.get("seq")), m)
    out = list(merged.values())
    out.sort(key=lambda m: (m.get("ts", 0.0), m.get("seq", 0)))
    return out


def request_timeline(request_id: str) -> List[Dict[str, Any]]:
    """Every recorded mark of ONE request, cluster-wide, in causal
    (wall-clock) order: the router's marks from the caller's node
    interleaved with the engine's from the replica's node on the shared
    request id. Render with `serve.reqlog.render_waterfall(marks)`."""
    return [m for m in _federated_request_marks() if m.get("rid") == request_id]


def list_requests(tenant: Optional[str] = None, slow_only: bool = False,
                  limit: int = 200) -> List[Dict[str, Any]]:
    """Cluster-wide request summaries (newest last): request id, tenant,
    first/last phase, terminal outcome, TTFT and its decomposition buckets.
    `slow_only` keeps requests whose TTFT exceeded the serve objective or
    that timed out — the on-call's worklist."""
    from ..core.config import cfg
    from ..serve import reqlog

    merged: Dict[str, Dict[str, Any]] = {
        s["request_id"]: s for s in reqlog.summarize_marks(_federated_request_marks())
    }
    # the local summary index survives mark-ring eviction: it wins over a
    # summary rebuilt from a truncated federated tail
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


def _federated_step_marks() -> List[Dict[str, Any]]:
    """Every training-forensics step mark visible from this process: the
    local steplog ring merged with every node's federated tail in the GCS
    `_steps` table. Deduped by the SEMANTIC key (run, rank, step, phase):
    one sampled step's mark can reach the table both through its worker
    node's own federation and through the controller's re-ring after
    ingest. Sorted by wall time."""
    from ..core.gcs import STEPLOG_NS
    from ..train import steplog

    def _key(m: Dict[str, Any]) -> Any:
        return (m.get("run"), m.get("rank"), m.get("step"), m.get("phase"))

    merged: Dict[Any, Dict[str, Any]] = {}
    for m in steplog.log().since(0, max_n=1_000_000):
        merged[_key(m)] = m
    for m in _federated(STEPLOG_NS):
        merged.setdefault(_key(m), m)
    out = list(merged.values())
    out.sort(key=lambda m: (m.get("ts", 0.0), m.get("seq", 0)))
    return out


def step_timeline(run: str, rank: Optional[int] = None) -> List[Dict[str, Any]]:
    """Per-rank step-phase summaries of ONE training run, cluster-wide
    (sampled steps only), ordered by (step, rank). Each summary's buckets sum to its
    step wall time — render with `train.steplog.render_waterfall`."""
    from ..train import steplog

    out = [
        s for s in steplog.summarize_steps(_federated_step_marks())
        if s.get("run") == run and (rank is None or s.get("rank") == rank)
    ]
    out.sort(key=lambda s: (s.get("step", 0), s.get("rank", 0)))
    return out


def list_steps(run: Optional[str] = None,
               limit: int = 200) -> List[Dict[str, Any]]:
    """Cluster-wide sampled-step summaries (newest last): run, rank, step,
    wall seconds, phase buckets. The local summary index survives
    mark-ring eviction, so it wins over a summary rebuilt from a truncated
    federated tail."""
    from ..train import steplog

    merged: Dict[Any, Dict[str, Any]] = {
        (s.get("run"), s.get("rank"), s.get("step")): s
        for s in steplog.summarize_steps(_federated_step_marks())
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
    """Event tails for every cluster node, keyed by node id hex (an agent
    that does not answer gets one ERROR placeholder naming it)."""
    rt = _runtime()
    ctx = getattr(rt, "cluster", None)
    if ctx is None:
        return {"local": list_events(limit=limit)}
    out = ctx.fanout_nodes(
        "node_events", 0, limit,
        placeholder=lambda e: [{"severity": "ERROR", "source": "state",
                                "message": f"unreachable: {e!r}"}],
    )
    out[ctx.node_id.hex()] = list_events(limit=limit)
    return out


def cluster_logs(tail: int = 200) -> Dict[str, List[str]]:
    """Log tails for every cluster node, keyed by node id hex."""
    from . import logs

    return logs.cluster_tail(_runtime(), tail)
