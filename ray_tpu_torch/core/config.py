"""Typed flag registry with environment overrides.

Port of the registry of `ray_tpu/core/config.py` with only the flags the
port reads. A flag has the same name, default and type as in the JAX
package, and the same override `RAY_TPU_<NAME>` in the environment, so one
deployment's settings mean the same in both packages. Values resolve as
defaults < environment < `cfg.set(...)`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Any, Dict, Optional

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off", "")


def _parse(raw: str, type_: type) -> Any:
    if type_ is bool:
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        logging.getLogger(__name__).warning(
            "unrecognized boolean value %r; treating as true", raw
        )
        return True
    if type_ is int:
        return int(float(raw))  # accepts "8e9" style
    return type_(raw)


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    type: type
    doc: str

    @property
    def env_var(self) -> str:
        return "RAY_TPU_" + self.name.upper()


_REGISTRY: Dict[str, Flag] = {}


def define_flag(name: str, default: Any, doc: str, type_: Optional[type] = None) -> None:
    if name in _REGISTRY:
        raise ValueError(f"flag {name!r} already defined")
    _REGISTRY[name] = Flag(name, default, type_ or type(default), doc)


# object store (core/object_store.py)
define_flag("native_store", False,
            "Place large numpy arrays in the native C++ shared-memory arena.")
define_flag("object_store_capacity_bytes", 8 << 30,
            "Host-tier byte budget before LRU spill/eviction kicks in.")
define_flag("inline_max_bytes", 100 * 1024,
            "Objects at or under this size stay in the inline tier.")
define_flag("shm_min_bytes", 64 * 1024,
            "Numpy arrays at or over this size go to the native arena.")
define_flag("spill_dir", "",
            "Directory for spilled objects ('' = evict to LOST + lineage).")

# rpc (core/rpc.py)
define_flag("rpc_reconnect_attempts", 4,
            "Max RpcClient connection attempts per call (connect/send-phase "
            "failures only — a fully-sent frame is never resent).")
define_flag("rpc_reconnect_backoff_s", 0.1,
            "Base jittered backoff between RpcClient reconnect attempts "
            "(doubles per attempt, capped at 2s).")

# GCS persistence (core/gcs.py snapshots and WAL, core/runtime.py restore)
define_flag("gcs_snapshot_path", "",
            "File path for periodic GCS table snapshots ('' = disabled).")
define_flag("gcs_snapshot_interval_s", 5.0,
            "Seconds between GCS snapshots when snapshotting is enabled.")
define_flag("gcs_wal", True,
            "Journal every GCS mutation to <gcs_snapshot_path>.wal so "
            "--restore replays acknowledged writes made after the last "
            "snapshot (snapshots compact the journal; needs a snapshot "
            "path).")
define_flag("gcs_wal_fsync", False,
            "fsync the GCS WAL after every record: survives host power "
            "loss, not just head-process death, at a per-write cost.")
define_flag("head_outage_grace_s", 30.0,
            "After head.unreachable, the serve router keeps dispatching "
            "on cached replica membership and the controller suppresses "
            "probe-driven replica kills for this long; past it the "
            "outage is treated as real capacity loss.")
define_flag("head_reconcile_grace_s", 0.0,
            "How long a restored head waits for surviving agents to "
            "re-announce before purging never-returned nodes and "
            "declaring their restored actors/bundles dead "
            "(0 = 3x node_stale_s).")

# the GCS served over RPC (core/gcs_service.py)
define_flag("gcs_client_retry_s", 3.0,
            "Bounded window a GcsClient call retries transport errors "
            "with jittered backoff before raising the typed "
            "HeadUnavailableError (degraded-mode entry point).")
define_flag("gcs_client_backoff_s", 0.05,
            "Base jittered backoff between GcsClient retries during a "
            "head outage (doubles per attempt, capped at 1s).")

# cluster (core/cluster.py: multi-process / multi-host composition)
define_flag("node_heartbeat_s", 0.5,
            "Interval at which cluster nodes report resources to the GCS.")
define_flag("node_stale_s", 5.0,
            "A node missing from heartbeats this long is declared dead.")
define_flag("system_failure_retries", 3,
            "Automatic resubmits of a task whose executing node died.")
define_flag("remote_inline_max_bytes", 512 * 1024,
            "Remote task results at or under this size return by value; "
            "larger ones stay on the executing node and get() pulls them.")
define_flag("cluster_bind_host", "127.0.0.1",
            "Host address cluster services bind to (0.0.0.0 for multi-host; "
            "set a cluster token when leaving localhost).")
define_flag("foreign_locate_max_s", 300.0,
            "get() on a ref from another process gives up (ObjectLostError) "
            "after polling the object directory this long with no location "
            "registered. Raise it when cross-driver refs point at tasks "
            "that legitimately run longer before sealing their result.")
define_flag("agent_admission_queue", 0,
            "Length of a node agent's admission queue for tasks its ledger "
            "cannot admit yet (0 = 4x its CPU count, min 8); overflow "
            "bounces dispatches back to the owner for rescheduling.")
define_flag("result_delivery_attempts", 6,
            "Delivery attempts for a task completion before the agent parks "
            "the result for the owner's recovery poll.")
define_flag("parked_result_ttl_s", 600.0,
            "How long an agent keeps an undeliverable task result parked "
            "for the owner to re-poll before dropping it.")
define_flag("pending_task_poll_s", 10.0,
            "Owner re-polls the executing agent about a dispatched task "
            "after this long without a completion report.")
define_flag("pg_reschedule_budget", 5,
            "Re-reservation attempts for a placement group whose bundle "
            "host died before the group is marked FAILED.")
define_flag("pg_reschedule_backoff_s", 0.5,
            "Base backoff between placement-group reschedule attempts "
            "(doubles per attempt, capped at 8s).")
define_flag("pg_reschedule_wait_s", 60.0,
            "How long dependents (bundle-actor restarts, gang re-mesh) "
            "wait for a RESCHEDULING placement group to re-reserve.")
define_flag("preempt_warning_s", 10.0,
            "Warning window a SIGTERM-preempted node agent announces "
            "before it shuts down (cloud maintenance/spot semantics).")
define_flag("autoscaler_drain_grace_s", 2.0,
            "Grace period the capacity plane gives a retiring node "
            "between the drain mark and forced termination.")
define_flag("spot_preempt_warning_s", 3.0,
            "Default warning window SpotNodeProvider preemption "
            "schedules announce before reclaiming a spot node.")

# process workers (core/worker_pool.py)
define_flag("worker_idle_timeout_s", 60.0,
            "Idle process workers are reaped after this many seconds.")
define_flag("max_process_workers", 0,
            "Upper bound on pooled worker processes (0 = one per CPU core).")

# health (core/health.py)
define_flag("health_check_period_s", 0.5,
            "Interval between node/actor health probes.")
define_flag("health_check_failures", 3,
            "Consecutive probe failures before a target is marked dead.")
define_flag("memory_monitor_interval_s", 0.25,
            "Polling interval of the host memory monitor (0 = disabled).")
define_flag("memory_usage_threshold", 0.95,
            "Fraction of host memory in use that triggers the OOM policy.")
define_flag("oom_policy", "retriable_fifo",
            "Worker-killing policy: 'retriable_fifo' or 'group_by_owner'.")

# serve resilience (serve/router.py)
define_flag("serve_default_timeout_s", 0.0,
            "Default end-to-end deadline for serve requests in seconds "
            "(0 = no deadline); per-handle options(timeout_s=...) wins.")
define_flag("serve_retry_max_attempts", 3,
            "Total router attempts per serve request (1 = no failover); "
            "retried only on replica-death/transport-class errors.")
define_flag("serve_retry_backoff_s", 0.05,
            "Base jittered backoff between router failover attempts "
            "(doubles per attempt, capped at 2s).")
define_flag("serve_reaper_max_tracked", 4096,
            "Cap on request refs the serve reaper tracks; overflow "
            "releases + drops the oldest entry and bumps a warning metric.")
define_flag("serve_tenant_header", "x-tenant",
            "HTTP header carrying the tenant id on the OpenAI frontend "
            "and the serve proxy ('x-priority' rides alongside).")

# tracing (util/tracing.py)
define_flag("trace_sample_ratio", 1.0,
            "Fraction of new traces recorded by util/tracing (0 disables; "
            "the root's decision propagates to every descendant span).")
define_flag("trace_buffer_spans", 50_000,
            "Per-process ring-buffer capacity for completed trace spans.")

# request forensics (serve/reqlog.py)
define_flag("serve_request_log", True,
            "Record per-request typed phase marks (serve/reqlog.py) "
            "(False = recorder off; request ids still thread through).")
define_flag("serve_request_log_marks", 4096,
            "Per-process ring capacity for request phase marks; the "
            "oldest mark is evicted first.")
define_flag("serve_request_log_requests", 1024,
            "Per-process cap on request SUMMARIES the recorder indexes "
            "(oldest request evicted first).")
define_flag("reqlog_federate_batch", 256,
            "Max request marks a node ships into the GCS _requests "
            "table per stats-piggyback period (cursor walk, never "
            "skips).")
define_flag("reqlog_table_cap", 2000,
            "Per-node cap on request marks retained in the GCS "
            "_requests table (the cluster-wide queryable tail).")

# multi-tenant serve (weighted-fair admission / quotas / preemption)
define_flag("serve_tenant_default_weight", 1.0,
            "Weighted-fair share for tenants without an explicit weight "
            "(serve/tenancy.py set_tenant overrides per tenant).")
define_flag("serve_tenant_quota_rps", 0.0,
            "Default per-tenant token-bucket refill rate in requests/sec "
            "applied at engine admission (0 = unlimited; per-tenant "
            "overrides via tenancy.set_tenant(quota_rps=...)).")
define_flag("serve_tenant_quota_burst", 0.0,
            "Default token-bucket burst capacity in requests "
            "(0 = auto: max(1, 2x the refill rate)).")
define_flag("serve_lane_preemption", True,
            "Let the paged engine preempt strictly-lower-priority decode "
            "lanes under page-pool/slot pressure: the lane is trimmed to "
            "its emitted frontier, its pages released (prefix-shared "
            "pages only drop a refcount), and the request parked for a "
            "token-exact resume.")
define_flag("serve_slo_ttft_p99_s", 0.0,
            "Serve SLO monitor: p99 TTFT above this burns "
            "raytpu_serve_slo_burn_total{slo=ttft_p99} (0 = disabled).")
define_flag("serve_slo_queue_p99_s", 0.0,
            "Serve SLO monitor: p99 engine queue wait above this burns "
            "raytpu_serve_slo_burn_total{slo=queue_p99} (0 = disabled).")
define_flag("serve_slo_check_period_s", 5.0,
            "Interval between serve SLO monitor evaluations of the "
            "span-derived latency histograms.")
define_flag("autoscale_burn_windows", 1,
            "New SLO-violating windows (ServeSLOMonitor attainment "
            "ledger) since the last autoscale pass that trigger a "
            "one-replica scale-up for slo_driven deployments "
            "(0 disables the SLO term).")
define_flag("autoscale_pressure_floor", 0.25,
            "Minimum demand signal (router ongoing-per-replica over "
            "target, or max engine batch_fill) required before an SLO "
            "burn may scale up: a burn with an idle router is a "
            "cold-start artifact, not missing capacity.")

# train resilience
define_flag("train_ckpt_keep", 2,
            "Session (pickle) checkpoints retained per trial dir when "
            "RunConfig.checkpoint.session_keep is unset.")

# telemetry plane (core/stats.py)
define_flag("node_stats_period_s", 2.0,
            "Interval at which a cluster node piggybacks its stats "
            "snapshot into the GCS node table (0 = disabled).")

# training stall watchdog (util/watchdog.py StallWatchdog)
define_flag("train_stall_window_s", 30.0,
            "Training stall watchdog: no worker report for this long "
            "flips raytpu_train_stalled and emits a WARNING (0 = off).")
define_flag("train_stall_factor", 6.0,
            "Training stall watchdog: a worker whose report gap exceeds "
            "factor x its EWMA step time is flagged as the straggler.")
define_flag("train_stall_ewma_alpha", 0.25,
            "EWMA smoothing for per-worker step-time tracking in the "
            "stall watchdog (higher = faster adaptation).")
define_flag("train_stall_min_s", 1.0,
            "Floor on the EWMA-regression stall threshold so fast steps "
            "with scheduler jitter do not flap the stalled gauge.")

# training: data-parallel sync knobs, JAX's names and defaults. On one
# device nothing syncs and every mode runs the standard step; across the
# ranks of a dp mesh they pick the sync (train/lm.py)
define_flag("dp_allreduce_dtype", "f32",
            "Wire dtype of the data-parallel gradient sync: 'f32' (exact) "
            "or 'int8' (block-quantized all-reduce with error feedback).")
define_flag("dp_shard_update", False,
            "Shard the weight update + optimizer state across the dp axis "
            "(reduce-scatter grads, shard-local Adam, all-gather params).")
define_flag("dp_quant_block", 512,
            "Block size of the int8 gradient quantizer (one f32 scale per "
            "block of this many elements).")

# training forensics (train/steplog.py)
define_flag("train_step_log", True,
            "Record per-rank typed step phase marks on sampled training "
            "steps (train/steplog.py) (False = mark() is a no-op).")
define_flag("step_log_sample_every", 32,
            "Sample every Nth training step for the step-phase "
            "decomposition; only sampled steps synchronise the device, "
            "every other step keeps the queue running ahead (0 = never "
            "sample).")
define_flag("train_step_log_marks", 4096,
            "Per-process ring capacity for step phase marks; the "
            "oldest mark is evicted first.")
define_flag("train_step_log_steps", 1024,
            "Per-process cap on step SUMMARIES the recorder indexes "
            "(oldest sampled step evicted first).")
define_flag("steplog_federate_batch", 256,
            "Max step marks a node ships into the GCS _steps table "
            "per stats-piggyback period (cursor walk, never skips).")
define_flag("steplog_table_cap", 2000,
            "Per-node cap on step marks retained in the GCS _steps "
            "table (the cluster-wide queryable tail).")
define_flag("steplog_dp_bandwidth_gbs", 100.0,
            "Assumed interconnect bandwidth (GB/s) used to ESTIMATE "
            "the dp_sync share of device step time on sampled steps "
            "(0 s on one replica, where nothing syncs).")

# event log segments (util/events.py)
define_flag("events_segment_bytes", 1 << 20,
            "Rotate a node's current event segment file once it exceeds "
            "this many bytes (atomic rename into a numbered segment).")
define_flag("events_segments_keep", 8,
            "Rotated event segments retained per node before the oldest "
            "is pruned.")
define_flag("events_federate_batch", 256,
            "Max events a node ships into the GCS _events table per "
            "stats-piggyback period (the cursor never skips; a burst "
            "just takes more periods to drain).")
define_flag("events_table_cap", 2000,
            "Per-node cap on events retained in the GCS _events table "
            "(the cluster-wide queryable tail).")

# profiling plane (util/profiling.py: captures and cost accounting)
define_flag("profile_default_duration_s", 2.0,
            "Default capture window for state.profile() device+host "
            "captures.")
define_flag("profile_max_artifact_bytes", 32 << 20,
            "Per-capture cap on artifact bytes collected (largest trace "
            "files dropped first).")
define_flag("profile_host_sample_s", 0.005,
            "Sampling interval of the host-side stack profiler that "
            "rides along with device captures.")
define_flag("profile_store_capacity", 8,
            "Captures retained in the runtime's profile store before the "
            "oldest (meta + artifacts) is dropped.")
define_flag("profile_merge_max_events", 20_000,
            "Device-trace events merged into one Perfetto export by "
            "trace_dump(profile_id=...); longest durations win.")
define_flag("profile_cost_accounting", True,
            "Compute MFU/roofline figures for train reports and engine "
            "ticks from the step's counted FLOPs and bytes "
            "(util/profiling.step_cost: one run of the step on meta "
            "tensors, cached).")


class RayTpuConfig:
    """Resolved flag values: defaults < env (RAY_TPU_<NAME>) < set() overrides."""

    def __init__(self):
        self._lock = threading.Lock()
        self._overrides: Dict[str, Any] = {}

    def __getattr__(self, name: str) -> Any:
        flag = _REGISTRY.get(name)
        if flag is None:
            raise AttributeError(f"no such flag: {name!r}")
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        raw = os.environ.get(flag.env_var)
        if raw is not None:
            try:
                return _parse(raw, flag.type)
            except (ValueError, TypeError) as e:
                raise ValueError(f"bad value for {flag.env_var}={raw!r}: {e}") from None
        return flag.default

    def set(self, **overrides: Any) -> None:
        """Programmatic overrides."""
        for name, value in overrides.items():
            flag = _REGISTRY.get(name)
            if flag is None:
                raise ValueError(f"unknown config flag {name!r}; known: {sorted(_REGISTRY)}")
            if value is not None and not isinstance(value, flag.type):
                try:
                    value = flag.type(value)
                except (ValueError, TypeError):
                    raise ValueError(
                        f"flag {name!r} expects {flag.type.__name__}, got "
                        f"{type(value).__name__}"
                    ) from None
            with self._lock:
                self._overrides[name] = value

    def reset(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._overrides.clear()
            else:
                self._overrides.pop(name, None)


cfg = RayTpuConfig()


def head_reconcile_grace() -> float:
    """`head_reconcile_grace_s` resolved: 0 means 3x `node_stale_s`."""
    return float(cfg.head_reconcile_grace_s) or 3.0 * float(cfg.node_stale_s)
