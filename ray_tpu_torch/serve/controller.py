"""ServeController: reconciles target deployment state against live actors.

Port of `ray_tpu/serve/controller.py`. One reconcile thread owns: replica
start/stop, health probes with restarts, ongoing-request autoscaling, and
graceful draining — scale-down and redeploy mark replicas DRAINING (the
router stops picking them; in-flight requests finish up to a drain
deadline) before the actor is killed. Replicas are thread actors with
`max_concurrency = max_ongoing_requests`; their constructor arguments
(the model's weight tensors, for an LLM app) are passed by reference.

A replica whose constructor raises dies at once; the reconcile loop
prunes it and starts another, as in the JAX package, so `run` returns
and a call fails with the ActorDiedError that carries the constructor's
error. The port's `status()` also names the last replica death of each
deployment (`last_replica_death`).

Autoscaling has the JAX package's two terms: ongoing requests over
`target_ongoing_requests`, and for `AutoscalingConfig(slo_driven=True)`
new burn windows in the `ServeSLOMonitor` ledger, which bump the target
one replica past the live count when a demand signal (ongoing per replica
over target, or the engines' `batch_fill`) clears
`autoscale_pressure_floor`.

Not ported yet: the cluster autoscaler's demand source (`core/capacity`)
and the freeze of reconciliation under a GCS head outage, which come with
ROADMAP A6b (capacity; head restart).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import api
from ..core.actors import ActorState
from ..core.exceptions import ReplicaDrainingError, RequestTimeoutError
from .deployment import Application, Deployment
from .router import _counter, _rkey, DeploymentHandle, ReplicaSet

logger = logging.getLogger(__name__)


class _ReplicaWrapper:
    """Actor body: hosts the user's deployment instance."""

    def __init__(self, cls, args, kwargs):
        self._draining = False
        self._instance = cls(*args, **kwargs)

    def prepare_drain(self) -> str:
        """Controller marks this replica DRAINING: in-flight calls finish,
        new calls are rejected with a typed (router-retryable) error."""
        self._draining = True
        return "draining"

    def call(self, method: str, *args, **kwargs):
        from . import context as serve_ctx
        from .multiplex import _set_model_id

        model_id = kwargs.pop("_multiplexed_model_id", None)
        deadline = kwargs.pop("_deadline_ts", None)
        tenant = kwargs.pop("_tenant", None)
        priority = kwargs.pop("_priority", None)
        request_id = kwargs.pop("_request_id", None)
        if self._draining:
            # a call that raced the drain mark: bounce it so the router
            # fails over instead of queueing work behind a dying replica
            raise ReplicaDrainingError(
                f"replica is draining; retry {method!r} on a live replica"
            )
        if deadline is not None and time.time() >= deadline:
            raise RequestTimeoutError(
                f"request deadline expired before {method!r} started"
            )
        _set_model_id(model_id)
        token = serve_ctx._set_request_deadline(deadline)
        tenant_token = serve_ctx._set_request_tenant(tenant, priority)
        rid_token = serve_ctx._set_request_id(request_id)
        try:
            result = getattr(self._instance, method)(*args, **kwargs)
            if hasattr(result, "__next__") and (
                model_id or deadline is not None or tenant is not None
                or request_id is not None
            ):
                # generator bodies run at iteration time (the streaming
                # executor drains them after this returns): re-establish
                # the model-id + deadline + tenant + request-id context
                # around actual execution
                return _with_request_context(
                    result, model_id, deadline, tenant, priority,
                    request_id,
                )
            return result
        finally:
            serve_ctx._reset_request_id(rid_token)
            serve_ctx._reset_request_tenant(tenant_token)
            serve_ctx._reset_request_deadline(token)
            _set_model_id(None)

    def health(self) -> str:
        check = getattr(self._instance, "check_health", None)
        if check is not None:
            check()
        return "ok"

    def __ray_shutdown__(self) -> None:
        """The replica's actor stopped: let the deployment instance release
        what it holds (an LLMServer stops its engine and drops it)."""
        hook = getattr(self._instance, "__ray_shutdown__", None)
        if hook is not None:
            hook()


def _with_request_context(gen, model_id: Optional[str],
                          deadline: Optional[float],
                          tenant: Optional[str] = None,
                          priority: Optional[int] = None,
                          request_id: Optional[str] = None):
    from . import context as serve_ctx
    from .multiplex import _set_model_id

    _set_model_id(model_id)
    token = serve_ctx._set_request_deadline(deadline)
    tenant_token = serve_ctx._set_request_tenant(tenant, priority)
    rid_token = serve_ctx._set_request_id(request_id)
    try:
        yield from gen
    finally:
        serve_ctx._reset_request_id(rid_token)
        serve_ctx._reset_request_tenant(tenant_token)
        serve_ctx._reset_request_deadline(token)
        _set_model_id(None)


class _DeploymentState:
    """Per-deployment record in the controller."""

    def __init__(self, deployment: Deployment, app: Application,
                 source_app: Optional[Application] = None):
        self.deployment = deployment
        self.app = app
        # the ORIGINAL (unresolved) Application object: child-dedup keys on
        # its identity so shared children deploy once but a fresh .bind()
        # redeploys
        self.source_app = source_app if source_app is not None else app
        self.target_replicas = deployment.config.num_replicas
        if deployment.config.autoscaling:
            self.target_replicas = deployment.config.autoscaling.min_replicas
        self.replicas: List[Any] = []
        self.replica_set = ReplicaSet(
            deployment.name,
            max_ongoing=deployment.config.max_ongoing_requests,
            max_queued=deployment.config.max_queued_requests,
        )
        self.last_scale_down = time.time()
        # readiness/probe tracking for the health pruner (keyed by actor
        # id hex — stable, unlike id() which recycles addresses)
        self.started_at: Dict[str, float] = {}
        self.ready_at: Dict[str, float] = {}
        self.probe_refs: Dict[str, Any] = {}   # key -> (ref, sent_at)
        self.last_probe: Dict[str, float] = {}
        # DRAINING replicas: key -> (handle, force-kill deadline). Out of
        # `replicas` (never routed/probed) but kept alive until their
        # ongoing count hits zero or the drain deadline passes.
        self.draining: Dict[str, Tuple[Any, float]] = {}
        # why the last pruned replica died (a constructor that raised, a
        # kill), for status()
        self.last_death: Optional[str] = None

    def forget(self, key: str) -> None:
        for d in (self.started_at, self.ready_at, self.probe_refs, self.last_probe):
            d.pop(key, None)


class ServeController:
    """In-process controller; reconcile loop runs on a daemon thread."""

    def __init__(self, reconcile_interval_s: float = 0.2):
        self._states: Dict[str, _DeploymentState] = {}  # guarded-by: _lock
        # deleted/redeployed deployments whose replicas are still draining
        self._condemned: List[_DeploymentState] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._interval = reconcile_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle

    def deploy(self, app: Application, _is_child: bool = False) -> DeploymentHandle:
        # COMPOSITION (reference: deployment graphs / handle chaining):
        # an Application passed as an init arg deploys first and is
        # replaced by its DeploymentHandle, so deployments call
        # deployments through the router (per-hop load balancing).
        dep = app.deployment
        with self._lock:
            existing = self._states.get(dep.name)
        if _is_child and existing is not None and existing.source_app is app:
            # the SAME Application object (shared child: bound twice in one
            # graph, or across parents) deploys once; a redeploy with a
            # fresh .bind() is a different object and replaces below
            return DeploymentHandle(existing.replica_set)
        if existing is not None:
            self.delete(dep.name)  # redeploy: old replicas drain out
        source_app = app
        init_args = tuple(
            self.deploy(a, _is_child=True) if isinstance(a, Application) else a
            for a in app.init_args
        )
        init_kwargs = {
            k: self.deploy(v, _is_child=True) if isinstance(v, Application) else v
            for k, v in app.init_kwargs.items()
        }
        app = Application(app.deployment, init_args, init_kwargs)
        with self._lock:
            state = _DeploymentState(dep, app, source_app=source_app)
            self._states[dep.name] = state
        from ..util.events import emit

        emit("INFO", "serve",
             f"deployment {dep.name} deployed "
             f"(target {state.target_replicas} replica(s))",
             kind="serve.deploy", deployment=dep.name,
             target_replicas=state.target_replicas)
        self._reconcile_one(state)  # synchronous first bring-up
        self._ensure_thread()
        return DeploymentHandle(state.replica_set)

    def get_handle(self, name: str) -> DeploymentHandle:
        with self._lock:
            if name not in self._states:
                raise KeyError(f"no deployment {name!r}; have {list(self._states)}")
            return DeploymentHandle(self._states[name].replica_set)

    def delete(self, name: str, drain: bool = True) -> None:
        """Remove a deployment. With drain=True (the default) its live
        replicas go DRAINING — they finish in-flight requests up to the
        drain deadline before being killed; drain=False kills instantly."""
        with self._lock:
            state = self._states.pop(name, None)
        if not state:
            return
        if drain:
            for r in list(state.replicas):
                self._begin_drain(state, r)
            state.replicas = []
            state.replica_set.set_replicas([])
            with self._lock:
                if state.draining:
                    self._condemned.append(state)
            if state.draining:
                self._ensure_thread()
            return
        for r in state.replicas:
            _kill_quietly(r)
        for key, (r, _) in list(state.draining.items()):
            _kill_quietly(r)
            state.replica_set.finish_draining(key)
        state.draining.clear()
        state.replica_set.set_replicas([])

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        with self._lock:
            names = list(self._states)
            condemned = list(self._condemned)
            self._condemned = []
        for name in names:
            self.delete(name, drain=False)
        for state in condemned:
            for key, (r, _) in list(state.draining.items()):
                _kill_quietly(r)
                state.replica_set.finish_draining(key)
            state.draining.clear()

    def status(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                name: {
                    "target_replicas": s.target_replicas,
                    "live_replicas": len(s.replicas),
                    "draining_replicas": len(s.draining),
                    "ongoing": s.replica_set.total_ongoing(),
                    "last_replica_death": s.last_death,
                }
                for name, s in self._states.items()
            }

    # ------------------------------------------------------------- reconcile

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serve-controller"
            )
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            with self._lock:
                states = list(self._states.values())
                condemned = list(self._condemned)
            for state in states:
                try:
                    self._autoscale(state)
                    self._reconcile_one(state)
                except Exception:
                    logger.exception("reconcile failed for %s", state.deployment.name)
            for state in condemned:
                try:
                    self._reap_draining(state)
                except Exception:
                    logger.exception("drain reap failed for %s", state.deployment.name)
                if not state.draining:
                    with self._lock:
                        try:
                            self._condemned.remove(state)
                        except ValueError:
                            pass

    def _begin_drain(self, state: _DeploymentState, victim: Any) -> None:
        """Move a replica to DRAINING: the router stops picking it, the
        replica bounces new calls, and the reaper below kills it once its
        ongoing count drains (or the drain deadline passes)."""
        key = _rkey(victim)
        state.replica_set.mark_draining(key)
        state.forget(key)
        state.draining[key] = (
            victim,
            time.monotonic() + state.deployment.config.drain_timeout_s,
        )
        from ..util.events import emit

        emit("INFO", "serve",
             f"deployment {state.deployment.name}: replica {key[:12]} "
             f"draining", kind="serve.drain",
             deployment=state.deployment.name, replica=key,
             ongoing=state.replica_set.ongoing_for(key))
        try:
            victim.prepare_drain.remote()  # best-effort flag on the actor
        except Exception:
            pass

    def _reap_draining(self, state: _DeploymentState) -> None:
        now = time.monotonic()
        for key, (victim, kill_at) in list(state.draining.items()):
            ongoing = state.replica_set.ongoing_for(key)
            if ongoing <= 0 or now >= kill_at:
                if ongoing > 0:
                    _counter(
                        "raytpu_serve_drain_forced_total",
                        "draining replicas force-killed at the drain deadline",
                    ).inc()
                    logger.warning(
                        "drain deadline passed for %s replica %s with %d "
                        "request(s) still in flight; force-killing",
                        state.deployment.name, key[:12], ongoing,
                    )
                else:
                    _counter(
                        "raytpu_serve_drained_total",
                        "replicas drained cleanly before removal",
                    ).inc()
                _kill_quietly(victim)
                state.replica_set.finish_draining(key)
                del state.draining[key]

    def _reconcile_one(self, state: _DeploymentState) -> None:
        dep = state.deployment
        # Health/readiness pruning. Probes are NON-BLOCKING (fired on the
        # health_check_period_s cadence, harvested next rounds) so one
        # slow replica can never stall reconciliation of every deployment.
        # A replica still STARTING (its __init__ may legitimately spend
        # minutes loading weights or capturing graphs on the card) is not
        # unhealthy until startup_grace_s expires — readiness vs liveness,
        # like the reference's deployment FSM.
        live = []
        now = time.monotonic()
        for r in state.replicas:
            key = _rkey(r)
            if self._probe_ok(state, dep, r, key, now):
                live.append(r)
            else:
                state.last_death = _death_cause(r)
                _kill_quietly(r)
                state.forget(key)
        state.replicas = live
        # scale up
        started = 0
        while len(state.replicas) < state.target_replicas:
            # an EXPLICIT resources_per_replica charges exactly what it
            # says (num_cpus would clobber its CPU entry otherwise); the
            # default keeps replicas CPU-free as before
            explicit = dep.config.resources_per_replica
            actor_cls = api.remote(_ReplicaWrapper).options(
                max_concurrency=dep.config.max_ongoing_requests,
                resources=explicit or {"CPU": 1.0},
                num_cpus=float(explicit.get("CPU", 0.0)) if explicit else 0,
                name=f"serve:{dep.name}#{len(state.replicas)}-{time.monotonic_ns()}",
            )
            replica = actor_cls.remote(dep.cls, state.app.init_args, state.app.init_kwargs)
            state.started_at[_rkey(replica)] = time.monotonic()
            state.replicas.append(replica)
            started += 1
        if started:
            from ..util.events import emit

            emit("INFO", "serve",
                 f"deployment {dep.name}: +{started} replica(s) "
                 f"(target {state.target_replicas})",
                 kind="serve.scaled", deployment=dep.name,
                 direction="up", delta=started,
                 target_replicas=state.target_replicas)
        # scale down (newest first): drain, don't guillotine — READY
        # replicas may be mid-request; unready ones die immediately
        scaled_down = 0
        while len(state.replicas) > state.target_replicas:
            victim = state.replicas.pop()
            key = _rkey(victim)
            scaled_down += 1
            if key in state.ready_at and dep.config.drain_timeout_s > 0:
                self._begin_drain(state, victim)
            else:
                _kill_quietly(victim)
                state.forget(key)
        if scaled_down:
            from ..util.events import emit

            emit("INFO", "serve",
                 f"deployment {dep.name}: -{scaled_down} replica(s) "
                 f"(target {state.target_replicas})",
                 kind="serve.scaled", deployment=dep.name,
                 direction="down", delta=scaled_down,
                 target_replicas=state.target_replicas)
        self._reap_draining(state)
        # route only to READY replicas so requests never queue behind a
        # replica's __init__; fall back to all replicas during initial
        # bring-up (an empty set would hard-fail callers instead of
        # letting the first requests wait out the first compile)
        ready = [r for r in state.replicas if _rkey(r) in state.ready_at]
        state.replica_set.set_replicas(ready if ready else state.replicas)

    def _probe_ok(self, state: _DeploymentState, dep, r, key: str, now: float) -> bool:
        """Advance this replica's probe state machine; False = prune it."""
        cfg = dep.config
        pending = state.probe_refs.get(key)
        if pending is None:
            last = state.last_probe.get(key, 0.0)
            if now - last >= cfg.health_check_period_s:
                state.probe_refs[key] = (r.health.remote(), now)
                state.last_probe[key] = now
            return True
        ref, sent = pending
        failed = False
        if ref.is_ready():
            state.probe_refs.pop(key, None)
            try:
                api.get(ref, timeout=1)
                state.ready_at.setdefault(key, now)
                return True
            except Exception:
                failed = True
        elif now - sent > cfg.health_check_timeout_s:
            failed = True  # probe overdue (leave it pending: it completes
            # the moment a starting replica finishes __init__)
        if not failed:
            return True  # probe in flight, within budget
        still_starting = (
            key not in state.ready_at
            and now - state.started_at.get(key, now) < cfg.startup_grace_s
        )
        try:
            hard_dead = r.state() == ActorState.DEAD
        except Exception:
            hard_dead = True
        return still_starting and not hard_dead

    def _slo_burn_delta(self, state: _DeploymentState) -> int:
        """New SLO-violating windows in the ServeSLOMonitor attainment
        ledger since this deployment's last autoscale pass. The ledger is
        cumulative, so each state keeps a high-water mark; the monitor is
        process-global (SLOs are measured at the router, not per
        deployment), so every slo_driven deployment reacts to a burn."""
        from ..util.watchdog import serve_slo_monitor

        report = serve_slo_monitor().attainment_report()
        violated = sum(int(led.get("violated", 0)) for led in report.values())
        prev = getattr(state, "_slo_violated_seen", 0)
        state._slo_violated_seen = violated
        return max(0, violated - prev)

    @staticmethod
    def _engine_pressure() -> float:
        """Max batch_fill across registered engines (the
        raytpu_engine_batch_fill callback gauge): how full the decode
        batches actually are, the second demand signal next to the
        router's ongoing count."""
        from ..util.metrics import registry

        gauge = registry().get("raytpu_engine_batch_fill")
        if gauge is None:
            return 0.0
        return max((v for _t, v in gauge.collect()), default=0.0)

    def _autoscale(self, state: _DeploymentState) -> None:
        """Replica-target policy. Base term: ongoing requests over
        target_ongoing_requests. SLO term (slo_driven): new burn windows
        from the ServeSLOMonitor bump the target one replica past the live
        count — latency is burning while the ongoing count still looks
        fine (queued work waiting on slow TTFT counts as few ongoing
        requests). Targets only move here; _reconcile_one realizes them,
        so scale-down always rides the graceful drain path."""
        auto = state.deployment.config.autoscaling
        if auto is None:
            return
        import math

        from ..core.config import cfg
        from ..util.events import emit

        ongoing = state.replica_set.total_ongoing()
        desired = ongoing / auto.target_ongoing_requests
        target = max(auto.min_replicas, min(auto.max_replicas, math.ceil(desired)))
        reason = "ongoing"
        burn = 0
        if auto.slo_driven and cfg.autoscale_burn_windows > 0:
            burn = self._slo_burn_delta(state)
            if burn >= cfg.autoscale_burn_windows:
                live = max(len(state.replicas), state.target_replicas)
                pressure = max(desired / max(1, live), self._engine_pressure())
                if pressure >= cfg.autoscale_pressure_floor:
                    bumped = min(auto.max_replicas, live + 1)
                    if bumped > target:
                        target = bumped
                        reason = "slo_burn"
        if target > state.target_replicas:
            prev = state.target_replicas
            state.target_replicas = target
            state.last_scale_down = time.time()
            emit("INFO", "serve",
                 f"autoscaler: {state.deployment.name} target "
                 f"{prev} -> {target} ({reason}"
                 f"{f', {burn} burn window(s)' if burn else ''}, "
                 f"ongoing {ongoing})",
                 kind="serve.autoscale", deployment=state.deployment.name,
                 direction="up", reason=reason, burn_windows=burn,
                 ongoing=ongoing, target_replicas=target)
        elif target < state.target_replicas:
            # dampen scale-down; a fresh burn window also resets the timer
            # so a burning deployment never sheds capacity
            if burn > 0:
                state.last_scale_down = time.time()
                return
            if time.time() - state.last_scale_down > auto.scale_down_delay_s:
                prev = state.target_replicas
                state.target_replicas = target
                state.last_scale_down = time.time()
                emit("INFO", "serve",
                     f"autoscaler: {state.deployment.name} target "
                     f"{prev} -> {target} "
                     f"({'idle' if ongoing == 0 else 'ongoing'}, "
                     f"ongoing {ongoing})",
                     kind="serve.autoscale",
                     deployment=state.deployment.name, direction="down",
                     reason="idle" if ongoing == 0 else "ongoing",
                     burn_windows=0, ongoing=ongoing,
                     target_replicas=target)


def _death_cause(replica: Any) -> str:
    """Why a pruned replica died: its actor's death cause, or why its
    health probe failed."""
    from ..core.runtime import get_runtime

    try:
        rt = get_runtime().actor_runtime(replica._actor_id)
    except Exception:  # noqa: BLE001 - the runtime may be shutting down
        return "unknown"
    return rt.death_cause or f"health probe failed ({rt.state.value})"


def _kill_quietly(replica: Any) -> None:
    try:
        api.kill(replica)
    except Exception:
        pass
