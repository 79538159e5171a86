"""TrainController: the run state machine (reference parity:
train/v2/_internal/execution/controller/controller.py:91 — poll workers,
aggregate reports, apply the failure policy, restart the gang from the last
checkpoint).

Port of `ray_tpu/train/controller.py`. It drives a gang of thread
actors (`WorkerGroup`), of processes (`MultihostWorkerGroup`) or of
process actors on cluster agents (`ClusterWorkerGroup`). While the run
restarts, the next gang's bundles are the capacity plane's pending demand
(the `train:<run>` source, `core/capacity.py`). The
preemption pipeline below listens on this process's control-store
pub/sub, where `Runtime.preempt_node` announces a logical node and every
cluster member relays the notices of node agents (`core/cluster.py`).

Preemption pipeline: the controller subscribes to the GCS pubsub's
PREEMPT_CHANNEL. When a node hosting one of its workers announces
preemption, the controller (1) flips should_checkpoint/preempted flags
the workers observe through the poll plane, (2) waits up to the warning
window for an out-of-band checkpoint at the current step, then (3)
restarts the gang — the draining node is already out of every placement
path, so the new gang lands on survivors — WITHOUT burning the
FailureConfig.max_failures budget (announced losses are the common case
on spot fleets; real crashes stay budgeted)."""

from __future__ import annotations

import collections
import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..core.exceptions import ActorDiedError, RayTpuError, TaskError
from .config import FailureConfig, RunConfig, ScalingConfig
from .worker_group import WorkerGroup


class RunStatus(enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    RESTARTING = "RESTARTING"
    FINISHED = "FINISHED"
    ERRORED = "ERRORED"


@dataclasses.dataclass
class Result:
    """What fit() returns (reference air Result)."""

    metrics: Dict[str, Any]
    metrics_history: List[Dict[str, Any]]
    checkpoint_step: Optional[int]
    status: RunStatus
    error: Optional[str] = None
    num_restarts: int = 0
    # announced-preemption restarts, budgeted separately from failures
    num_preempt_restarts: int = 0
    # last cost-analysis accounting the gang reported (util/profiling):
    # mfu, step_flops, roofline fractions — None when the train_fn never
    # reported them (custom loops without LMTrainer.profiling_metrics)
    profiling: Optional[Dict[str, Any]] = None
    # wall-time attribution of the run (util/goodput): bucket seconds
    # summing to wall time, goodput fraction — the same numbers the
    # raytpu_train_goodput_seconds gauges and the BENCH block carry
    goodput: Optional[Dict[str, Any]] = None


class _PreemptRestart:
    """Sentinel outcome of a poll cycle: the gang must restart because a
    hosting node is being preempted (not a failure)."""

    def __init__(self, notice: Dict[str, Any], checkpointed: bool):
        self.notice = notice
        self.checkpointed = checkpointed


class FailurePolicy:
    """Retry budget (reference DefaultFailurePolicy default.py:13)."""

    def __init__(self, config: FailureConfig):
        self.max_failures = config.max_failures
        self.failures = 0

    def should_restart(self) -> bool:
        self.failures += 1
        if self.max_failures < 0:
            return True
        return self.failures <= self.max_failures


class TrainController:
    """Drives one training run: start gang → poll → (maybe restart) → result."""

    def __init__(
        self,
        train_fn: Callable,
        scaling: ScalingConfig,
        run_config: RunConfig,
        train_config: Optional[Dict[str, Any]] = None,
        poll_interval: float = 0.05,
        group_factory: Optional[Callable[[], Any]] = None,
        restart_backoff_s: float = 1.0,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.train_fn = train_fn
        self.scaling = scaling
        self.run_config = run_config
        self.train_config = train_config
        # name -> data.Dataset for the gang feed: each (re)start attempt
        # re-splits, so a restarted gang re-streams from block lineage
        self.datasets = datasets
        self.poll_interval = poll_interval
        # pause between restart attempts: a gang that died with its node
        # usually needs the cluster to DECLARE the death (heartbeat
        # staleness) and reschedule the placement group before a restart
        # can succeed — hot-looping would just burn the failure budget
        self.restart_backoff_s = restart_backoff_s
        # default: in-process actor gang; pass a factory building a
        # MultihostWorkerGroup for one-process-per-rank data parallelism
        # (train/multihost.py)
        self.group_factory = group_factory
        self.status = RunStatus.PENDING
        self.metrics_history: List[Dict[str, Any]] = []
        self.latest_checkpoint_step: Optional[int] = None
        self.num_restarts = 0
        self.num_preempt_restarts = 0
        self.world_sizes: List[int] = []  # gang size per (re)start attempt
        # preemption notices from the GCS pubsub (subscriber thread) →
        # drained by the poll loop
        self._preempt_lock = threading.Lock()
        self._preempt_notices: "collections.deque" = collections.deque()
        # stall/straggler watchdog of the CURRENT attempt (util/watchdog):
        # fed from the poll loop, inspectable by tests/status tooling
        self.stall_watchdog = None
        # newest cost-analysis accounting drained from rank-0 reports
        # (published as gauges by the poll loop; lands in Result.profiling)
        self.last_profiling: Optional[Dict[str, Any]] = None
        # wall-time goodput partition of the CURRENT run (util/goodput);
        # created by run(), transitioned by the poll loop, read by tests
        self.goodput = None
        self._attempt_reported = False

    def decide_num_workers(self) -> int:
        """Elastic sizing (reference v2 ScalingPolicy): fit the gang to
        currently-placeable resources, clamped to [min_workers,
        num_workers]. Fixed-size when min_workers is None."""
        want = self.scaling.num_workers
        floor = self.scaling.min_workers
        if floor is None:
            return want
        # a zero-worker gang would vacuously "finish" without training
        floor = max(1, floor)
        from .. import api

        per = self.scaling.worker_resources()
        avail = api.available_resources()
        feasible = want
        for res, amount in per.items():
            if amount > 0:
                feasible = min(feasible, int(avail.get(res, 0.0) // amount))
        return max(floor, min(want, feasible))

    def run(self) -> Result:
        # The whole run is one trace: gang attempts, restarts and
        # checkpoint restores nest as phase spans; device_annotate labels
        # each attempt in the torch.profiler trace (util/profiling) so
        # host phases line up with the card's kernels.
        from ..util import tracing
        from ..util.goodput import GoodputAccountant

        self.goodput = GoodputAccountant(self.run_config.name)
        self.goodput.begin("init")
        unsubscribe = self._subscribe_preemption()
        # while the run restarts, its next gang is pending demand even
        # before the new placement group is queued (the ledger drops it
        # once the group exists)
        from ..core.capacity import register_demand_source, unregister_demand_source

        source_name = f"train:{self.run_config.name}"
        register_demand_source(source_name, self._pending_capacity_demand)
        try:
            with tracing.span("train.run", run=self.run_config.name) as run_span:
                result = self._run_traced(run_span)
        finally:
            self.goodput.finish()
            unregister_demand_source(source_name)
            unsubscribe()
        return result

    def _pending_capacity_demand(self) -> List[Dict[str, Any]]:
        """DemandLedger source: the next gang's bundles while a restart
        is pending, origin "train"; empty while the gang runs and after
        the run ends."""
        if self.status != RunStatus.RESTARTING:
            return []
        per_worker = self.scaling.worker_resources()
        return [{
            "bundles": [dict(per_worker) for _ in range(self.decide_num_workers())],
            "origin": "train",
            "detail": f"gang restart of run {self.run_config.name}",
            "gang": True,
        }]

    # ------------------------------------------------------------- preemption

    def _subscribe_preemption(self) -> Callable[[], None]:
        """Listen for announced node preemptions on the local control
        store's pub/sub (in a cluster, members relay their peers'
        announcements into it). No-op when no runtime is initialized (a
        custom group run without one)."""
        from ..core import runtime as rt

        if not rt.is_initialized():
            return lambda: None
        from ..core.gcs import PREEMPT_CHANNEL

        pubsub = rt.get_runtime().gcs.pubsub
        pubsub.subscribe(PREEMPT_CHANNEL, self._on_preempt_notice)
        return lambda: pubsub.unsubscribe(
            PREEMPT_CHANNEL, self._on_preempt_notice
        )

    def _on_preempt_notice(self, msg: Any) -> None:
        if isinstance(msg, dict) and msg.get("node_hex"):
            with self._preempt_lock:
                self._preempt_notices.append(dict(msg))

    def _next_preempt_notice(self, group) -> Optional[Dict[str, Any]]:
        """Pop the first pending notice that affects this gang (a node
        hosting one of its bundles — or any node when the group's
        placement is opaque)."""
        while True:
            with self._preempt_lock:
                if not self._preempt_notices:
                    return None
                notice = self._preempt_notices.popleft()
            if self._notice_affects(group, notice):
                return notice

    @staticmethod
    def _notice_affects(group, notice: Dict[str, Any]) -> bool:
        pg = getattr(group, "pg", None)
        bundles = getattr(pg, "bundles", None) if pg is not None else None
        if not bundles:
            return True  # opaque placement: assume affected (safe side)
        hosts = {
            b.node.node_id.hex() for b in bundles if b.node is not None
        }
        return not hosts or notice.get("node_hex") in hosts

    def _run_traced(self, run_span) -> Result:
        from ..util import tracing

        policy = FailurePolicy(self.run_config.failure)
        error: Optional[str] = None
        while True:
            error = None
            preempt: Optional[_PreemptRestart] = None
            num_workers = self.decide_num_workers()
            self.world_sizes.append(num_workers)
            if self.group_factory is not None:
                group = self.group_factory()
            else:
                group = WorkerGroup(
                    num_workers,
                    self.scaling.worker_resources(),
                    run_name=self.run_config.name,
                    trial_dir=self.run_config.storage_path,
                    checkpoint_keep=self.run_config.checkpoint.session_keep,
                    # the step this attempt resumes from must survive
                    # worker-side pruning until a newer one lands
                    protect_step=self.latest_checkpoint_step,
                    datasets=self.datasets,
                )
            from ..util.events import emit

            attempt_span = tracing.tracer().start_span(
                "train.attempt", parent=run_span.context,
                lane=f"train:{self.run_config.name}",
                attrs={"run": self.run_config.name, "workers": num_workers,
                       "attempt": self.num_restarts + 1,
                       "resume_from_step": self.latest_checkpoint_step},
            )
            try:
                with tracing.use_context(attempt_span.context), \
                        tracing.device_annotate(
                            f"train.attempt:{self.run_config.name}"):
                    group.start()
                    self.status = RunStatus.RUNNING
                    emit("INFO", "train",
                         f"run {self.run_config.name}: gang of {num_workers} "
                         f"running (attempt {self.num_restarts + 1})",
                         kind="train.gang_started", run=self.run_config.name,
                         attempt=self.num_restarts
                         + self.num_preempt_restarts + 1,
                         workers=num_workers,
                         resume_from_step=self.latest_checkpoint_step)
                    outcome = self._poll_until_done(group)
                if outcome is None:  # clean finish
                    attempt_span.end(
                        checkpoint_step=self.latest_checkpoint_step
                    )
                    self.status = RunStatus.FINISHED
                    emit("INFO", "train",
                         f"run {self.run_config.name} finished "
                         f"({self.num_restarts} restart(s), "
                         f"{self.num_preempt_restarts} preemption(s))",
                         kind="train.finished", run=self.run_config.name)
                    return self._result(None)
                if isinstance(outcome, _PreemptRestart):
                    preempt = outcome
                else:
                    error = outcome
            except (ActorDiedError, TaskError, RayTpuError, RuntimeError,
                    TimeoutError) as e:
                error = repr(e)
            finally:
                attempt_span.end(
                    status="OK" if error is None else "ERROR",
                    error=error, preempted=preempt is not None,
                    checkpoint_step=self.latest_checkpoint_step,
                )
                group.shutdown()

            if preempt is not None:
                # announced node loss, ridden out: restart on survivors
                # WITHOUT burning the failure budget
                if not self._preempt_restart_allowed():
                    error = (
                        f"preemption of node "
                        f"{preempt.notice.get('node_hex', '?')[:12]} "
                        f"exceeded max_preempt_restarts"
                    )
                    self.status = RunStatus.ERRORED
                    emit("ERROR", "train",
                         f"run {self.run_config.name}: {error}",
                         kind="train.errored", run=self.run_config.name)
                    return self._result(error)
                self._begin_preempt_restart(preempt, run_span)
                continue

            if policy.should_restart():
                self.status = RunStatus.RESTARTING
                self.num_restarts += 1
                self.goodput.begin("ckpt_restore")
                emit("WARNING", "train",
                     f"run {self.run_config.name} restarting from "
                     f"checkpoint step {self.latest_checkpoint_step} "
                     f"(restart {self.num_restarts}): {error}",
                     kind="train.restart", run=self.run_config.name,
                     restart=self.num_restarts)
                # the train_fn is responsible for resuming from
                # latest_checkpoint_step (passed through train_config)
                with tracing.span("train.restore", parent=run_span.context,
                                  lane=f"train:{self.run_config.name}",
                                  run=self.run_config.name,
                                  restart=self.num_restarts,
                                  resume_from_step=self.latest_checkpoint_step):
                    self._set_resume_step()
                    if self.restart_backoff_s > 0:
                        time.sleep(self.restart_backoff_s)
                continue
            self.status = RunStatus.ERRORED
            emit("ERROR", "train",
                 f"run {self.run_config.name} errored after "
                 f"{self.num_restarts} restart(s): {error}",
                 kind="train.errored", run=self.run_config.name)
            return self._result(error)

    def _set_resume_step(self) -> None:
        """Record the resume step where the next attempt's train_fn reads
        it. Defaults train_config to {} — with a None config the resume
        step used to be dropped on the floor and every restart silently
        trained from scratch."""
        if self.train_config is None:
            self.train_config = {}
        self.train_config["resume_from_step"] = self.latest_checkpoint_step

    def _preempt_restart_allowed(self) -> bool:
        budget = getattr(
            self.run_config.failure, "max_preempt_restarts", -1
        )
        return budget < 0 or self.num_preempt_restarts < budget

    def _begin_preempt_restart(self, preempt: "_PreemptRestart",
                               run_span) -> None:
        from ..util import tracing
        from ..util.events import emit
        from ..util.metrics import get_or_create_counter

        self.status = RunStatus.RESTARTING
        self.num_preempt_restarts += 1
        self.goodput.begin("preempt_restart")
        get_or_create_counter(
            "raytpu_train_preempt_restarts_total",
            "Gang restarts triggered by announced node preemption "
            "(budgeted separately from failure restarts).",
        ).inc()
        emit("WARNING", "train",
             f"run {self.run_config.name} restarting after preemption of "
             f"node {preempt.notice.get('node_hex', '?')[:12]} "
             f"(emergency checkpoint "
             f"{'taken' if preempt.checkpointed else 'NOT taken'}, resume "
             f"step {self.latest_checkpoint_step}; failure budget untouched)",
             kind="train.preempt_restart", run=self.run_config.name,
             preempted_node=preempt.notice.get("node_hex"),
             emergency_checkpoint=preempt.checkpointed,
             resume_from_step=self.latest_checkpoint_step,
             preempt_restarts=self.num_preempt_restarts)
        with tracing.span("train.restore", parent=run_span.context,
                          lane=f"train:{self.run_config.name}",
                          run=self.run_config.name, preempted=True,
                          resume_from_step=self.latest_checkpoint_step):
            self._set_resume_step()
        # no backoff: the draining node is already excluded from
        # placement, and the warning window is burning — restart NOW

    def _poll_until_done(self, group: WorkerGroup):
        """Returns None on clean completion, an error string on worker
        failure, or a _PreemptRestart when a hosting node announced its
        death (after waiting out the emergency-checkpoint window)."""
        from ..util.watchdog import StallWatchdog

        result_refs = group.run_async(self.train_fn, self.train_config)
        cursors = [0] * group.num_workers
        notice: Optional[Dict[str, Any]] = None
        baseline_ckpt: Optional[int] = None
        flags_supported = True
        # stall/straggler watchdog: every drained report feeds it; every
        # poll cycle evaluates it (raytpu_train_stalled + WARNING events
        # naming the straggler rank)
        self.stall_watchdog = StallWatchdog(
            self.run_config.name, group.num_workers
        )
        self._attempt_reported = False
        try:
            return self._poll_cycle(
                group, result_refs, cursors, notice, baseline_ckpt,
                flags_supported,
            )
        finally:
            self.stall_watchdog.close()

    def _poll_cycle(self, group, result_refs, cursors, notice,
                    baseline_ckpt, flags_supported):
        while True:
            if notice is None:
                notice = self._next_preempt_notice(group)
                if notice is not None:
                    baseline_ckpt = self.latest_checkpoint_step
                    # the window between the notice and the restart is
                    # checkpoint traffic, not training
                    self.goodput.begin("ckpt_save")
                    from ..util.events import emit

                    emit("WARNING", "train",
                         f"run {self.run_config.name}: preemption notice "
                         f"for node {notice.get('node_hex', '?')[:12]} — "
                         f"requesting emergency checkpoint "
                         f"(window {notice.get('warning_s', 0):.1f}s)",
                         kind="preempt.notice", run=self.run_config.name,
                         preempted_node=notice.get("node_hex"),
                         warning_s=notice.get("warning_s", 0))
            try:
                if notice is not None and flags_supported:
                    try:
                        polls = group.poll(
                            cursors, should_checkpoint=True, preempted=True,
                            preempt_deadline=notice.get("deadline", 0.0),
                        )
                    except TypeError:
                        # a custom group without the preemption plane:
                        # still restart on the window, just without the
                        # out-of-band checkpoint request
                        flags_supported = False
                        polls = group.poll(cursors)
                else:
                    polls = group.poll(cursors)
            except (ActorDiedError, TaskError) as e:
                if notice is not None:
                    # the preempted node took the workers down before the
                    # window closed: still a preemption, not a failure
                    return _PreemptRestart(notice, checkpointed=False)
                return repr(e)
            for i, p in enumerate(polls):
                for metrics, ckpt_step, rank, ts in p["reports"]:
                    cursors[i] += 1
                    # RESERVED metrics keys from the trainer: the
                    # worker's monotonic clock (_mono, the wall-skew-
                    # proof watchdog feed) and its sampled-step records
                    # (_steplog) — popped before any metric publication
                    mono = None
                    step_records = None
                    if isinstance(metrics, dict):
                        mono = metrics.pop("_mono", None)
                        step_records = metrics.pop("_steplog", None)
                    self.stall_watchdog.observe_report(rank, ts, mono=mono)
                    if step_records:
                        self._observe_step_records(step_records)
                    if not self._attempt_reported:
                        # first report of the attempt: bring-up is over
                        # (unless a preemption window is already open)
                        self._attempt_reported = True
                        if notice is None:
                            self.goodput.begin("step_compute")
                    if isinstance(metrics, dict) and not metrics:
                        # a reserved-keys-only report (trailing steplog
                        # flush): control-plane only, nothing to publish
                        continue
                    if rank == 0:
                        self.metrics_history.append(metrics)
                        self.goodput.observe_report_metrics(metrics)
                        if isinstance(metrics, dict) and "mfu" in metrics:
                            self._publish_profiling(metrics)
                    if ckpt_step is not None:
                        prev = self.latest_checkpoint_step
                        self.latest_checkpoint_step = (
                            ckpt_step if prev is None else max(prev, ckpt_step)
                        )
                        if prev is None or ckpt_step > prev:
                            # instant span + flight-recorder event:
                            # checkpoint progress on the run's waterfall
                            from ..util import tracing
                            from ..util.events import emit

                            now = time.time()
                            tracing.tracer().record_span(
                                "train.checkpoint", now, now,
                                lane=f"train:{self.run_config.name}",
                                attrs={"run": self.run_config.name,
                                       "step": ckpt_step, "rank": rank},
                            )
                            emit("INFO", "train",
                                 f"run {self.run_config.name}: checkpoint "
                                 f"step {ckpt_step}"
                                 + (" (emergency)" if notice is not None
                                    else ""),
                                 kind="ckpt.saved",
                                 run=self.run_config.name, step=ckpt_step,
                                 rank=rank, emergency=notice is not None)
                if p["done"]:
                    # finished workers are not stragglers: silence from
                    # them must not trip the stall watchdog
                    self.stall_watchdog.mark_done(i)
                if p["error"]:
                    if notice is not None:
                        return _PreemptRestart(
                            notice, checkpointed=self._got_emergency_ckpt(
                                baseline_ckpt
                            )
                        )
                    return p["error"]
            if notice is not None:
                got = self._got_emergency_ckpt(baseline_ckpt)
                if got or time.time() >= notice.get("deadline", 0.0):
                    # emergency checkpoint landed (or the window closed):
                    # stop waiting and restart on surviving nodes
                    return _PreemptRestart(notice, checkpointed=got)
            if all(p["done"] for p in polls):
                # surface any exception held by the run() results
                # (Exception only: KeyboardInterrupt/SystemExit must abort
                # the controller, not count as a restartable worker failure)
                try:
                    group.finish(result_refs, timeout=10)
                except Exception as e:  # noqa: BLE001 - ferried to policy
                    return repr(e)
                return None
            self.stall_watchdog.check()
            # stall time is badput: swap the partition with the watchdog
            # verdict (only across the compute<->stall edge so a
            # preemption window's ckpt_save bucket is never clobbered)
            if self.stall_watchdog.stalled:
                if self.goodput.current == "step_compute":
                    self.goodput.begin("stall")
            elif self.goodput.current == "stall":
                self.goodput.begin("step_compute")
            time.sleep(self.poll_interval)

    def _publish_profiling(self, metrics: Dict[str, Any]) -> None:
        """Turn a rank-0 report's cost-analysis accounting (mfu,
        step_flops, roofline fractions — LMTrainer.profiling_metrics)
        into run-labeled gauges. The poll loop is the publisher so the
        numbers exist even when the caller never reads the Result."""
        from ..util.metrics import get_or_create_gauge

        tags = {"run": self.run_config.name}
        keep = {
            k: metrics[k]
            for k in ("mfu", "step_flops", "step_bytes", "step_time_s",
                      "roofline_hbm", "roofline_bound")
            if k in metrics
        }
        self.last_profiling = keep
        get_or_create_gauge(
            "raytpu_train_mfu",
            "Model-FLOPs utilization of the train step, from the compiled "
            "step's cost_analysis() over the measured step time.",
            tag_keys=("run",),
        ).set(float(metrics["mfu"]), tags=tags)
        if "step_flops" in metrics:
            get_or_create_gauge(
                "raytpu_train_step_flops",
                "Whole-program FLOPs of one compiled train step "
                "(cost_analysis; per-device flops x device count).",
                tag_keys=("run",),
            ).set(float(metrics["step_flops"]), tags=tags)
        if "roofline_hbm" in metrics:
            get_or_create_gauge(
                "raytpu_train_roofline_fraction",
                "Fraction of the chip roofline one train step achieves, "
                "per resource (compute = MFU, hbm = bandwidth share).",
                tag_keys=("run", "resource"),
            ).set(float(metrics["mfu"]), tags={**tags, "resource": "compute"})
            get_or_create_gauge(
                "raytpu_train_roofline_fraction",
                "Fraction of the chip roofline one train step achieves, "
                "per resource (compute = MFU, hbm = bandwidth share).",
                tag_keys=("run", "resource"),
            ).set(float(metrics["roofline_hbm"]),
                  tags={**tags, "resource": "hbm"})

    def _observe_step_records(self, records: Any) -> None:
        """Fan a worker's sampled step-phase records (the _steplog
        payload riding the report plane) into every consumer at once:
        the controller-side steplog ring (for state.step_timeline /
        skew_matrix / federation), the stall watchdog's per-rank bucket
        ledger (so a stall warning can name the straggler's dominant
        bucket), and the raytpu_train_step_seconds{run,bucket}
        histograms. Forensics must never kill a training run, so the
        whole fan-out is best-effort."""
        if not isinstance(records, (list, tuple)):
            return
        try:
            from ..util.metrics import (
                STEP_SECONDS_BOUNDARIES, get_or_create_histogram,
            )
            from . import steplog

            hist = get_or_create_histogram(
                "raytpu_train_step_seconds",
                "Per-phase wall seconds of sampled train steps "
                "(train/steplog decomposition; buckets sum to step "
                "wall time).",
                boundaries=STEP_SECONDS_BOUNDARIES,
                tag_keys=("run", "bucket"),
            )
            clean = [r for r in records if isinstance(r, dict)]
            # re-ring on the controller node: in-process gangs share the
            # singleton with their trainer, so ingest() dedups by
            # (run, rank, step, phase) and only fresh records re-record
            steplog.log().ingest(clean)
            for rec in clean:
                buckets = rec.get("buckets")
                rank = rec.get("rank")
                if not isinstance(buckets, dict):
                    continue
                if isinstance(rank, int):
                    self.stall_watchdog.observe_step_buckets(rank, buckets)
                run = str(rec.get("run", self.run_config.name))
                for phase, dur in buckets.items():
                    if isinstance(dur, (int, float)):
                        hist.observe(dur, tags={"run": run,
                                                "bucket": str(phase)})
        except Exception:  # noqa: BLE001 - forensics must not kill training
            pass

    def _got_emergency_ckpt(self, baseline: Optional[int]) -> bool:
        """A checkpoint newer than the pre-notice state has landed."""
        latest = self.latest_checkpoint_step
        return latest is not None and (baseline is None or latest > baseline)

    def _result(self, error: Optional[str]) -> Result:
        self.goodput.finish()
        return Result(
            metrics=self.metrics_history[-1] if self.metrics_history else {},
            metrics_history=list(self.metrics_history),
            checkpoint_step=self.latest_checkpoint_step,
            status=self.status,
            error=error,
            num_restarts=self.num_restarts,
            num_preempt_restarts=self.num_preempt_restarts,
            profiling=self.last_profiling,
            goodput=self.goodput.report(),
        )
