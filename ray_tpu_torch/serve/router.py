"""Handle-side routing: power-of-two-choices over replicas, with the
serve resilience layer — end-to-end deadlines, bounded retry/failover,
and admission control with load shedding.

Port of `ray_tpu/serve/router.py`: sample two replicas, pick the one with
the smaller ongoing-request count; retries re-pick a *different* live
replica on replica-death-class errors with jittered backoff;
`max_queued_requests` sheds with a typed BackPressureError; at ongoing
capacity, resilient unary calls park in a weighted-fair queue by tenant
and priority; requests carry an absolute deadline that fails fast once
expired (handle.options(timeout_s=...)); a resilient stream fails over
mid-stream, skipping the prefix already delivered. Registering a
deployment's replica set starts the serve SLO monitor when an objective is
configured (`util/watchdog.ensure_serve_slo_monitor`).

Degraded mode under a GCS head outage: replica calls go direct to the
node agents, so dispatch works without the head; an EMPTY membership
computed while the head is unreachable is control-plane blindness, not
replica death, so the router keeps its cached replicas for
`head_outage_grace_s`, and counts what it dispatched meanwhile
(`raytpu_serve_degraded_dispatch_total`).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Set

from .. import api
from ..core.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    BackPressureError,
    DeploymentUnavailableError,
    GetTimeoutError,
    ReplicaDrainingError,
    RequestTimeoutError,
    unwrap_error,
)
from ..core.chaos import ChaosInjectedError
from ..core.rpc import RpcError
from ..core.streaming import ObjectRefGenerator
from . import reqlog

logger = logging.getLogger(__name__)


def _mark_route(kwargs: Dict[str, Any], phase: str, **attrs) -> None:
    """Forensics mark keyed by the request id riding the private kwargs
    channel (`_request_id`); no-op when the call carries no id."""
    reqlog.mark(kwargs.get("_request_id"), phase,  # raylint: disable=request-phase
                tenant=kwargs.get("_tenant"), **attrs)

# Errors that indicate the REPLICA or transport failed (not the request):
# safe to fail over to a different replica. A user-code exception is not
# retryable — re-running it elsewhere would just fail the same way.
_RETRYABLE = (
    ActorDiedError,
    ActorUnavailableError,
    ReplicaDrainingError,
    RpcError,
    ConnectionError,
    ChaosInjectedError,
)


def _rkey(replica: Any) -> str:
    """Stable replica identity: the actor id. id() recycles once a
    swapped-out handle is GC'd, which let a new replica inherit false
    multiplex affinity; the actor id never does."""
    return replica._actor_id.hex()


def _counter(name: str, doc: str):
    from ..util.metrics import get_or_create_counter

    return get_or_create_counter(name, doc)


def _head_outage_s() -> float:
    """Seconds the GCS head has been unreachable from this process (0.0 =
    reachable, or no cluster): the serve data plane's degraded-mode
    probe."""
    from ..core.runtime import head_outage_s

    return head_outage_s()


def _retryable(err: BaseException) -> bool:
    return isinstance(unwrap_error(err), _RETRYABLE)


# live deployments' replica sets, for the ongoing-requests gauge (weak:
# a deleted deployment's series disappears instead of pinning the set)
import weakref  # noqa: E402 - scoped to the telemetry plumbing below

_replica_sets: "weakref.WeakSet" = weakref.WeakSet()


def _register_replica_set(rset: "ReplicaSet") -> None:
    from ..util.metrics import get_or_create_gauge
    from ..util.watchdog import ensure_serve_slo_monitor

    _replica_sets.add(rset)
    get_or_create_gauge(
        "raytpu_serve_ongoing_requests",
        "In-flight requests per deployment, from the router's ongoing "
        "counts.",
        tag_keys=("deployment",),
        fn=lambda: [
            ({"deployment": rs.name}, float(rs.total_ongoing()))
            for rs in list(_replica_sets)
        ],
    )
    ensure_serve_slo_monitor()


def _retry_backoff_s(attempt: int) -> float:
    """Jittered exponential backoff before failover attempt N (1-based)."""
    from ..core.config import cfg

    base = float(cfg.serve_retry_backoff_s)
    return min(2.0, base * (2 ** max(0, attempt - 1))) * (0.5 + random.random())


class ReplicaSet:
    """Live replica handles + ongoing counts, shared router/controller.

    Also owns the deployment's admission bound and pending-dispatch
    order: at ongoing capacity, resilient unary calls PARK in a
    weighted-fair queue (per-tenant SCFQ lanes, serve/tenancy.FairQueue)
    that the reaper grants from as replicas free up — so dispatch order
    under overload is weight-proportional per tenant, not FIFO. When
    `max_queued` >= 0, requests beyond the parked bound are shed with
    BackPressureError carrying a drain-rate Retry-After estimate (and
    `pick` keeps its ongoing-over-capacity bound for callers that bypass
    parking). DRAINING replicas stay known (their ongoing counts must
    drain to zero before the controller reaps them) but are never
    picked."""

    def __init__(self, name: str, *, max_ongoing: int = 8,
                 max_queued: int = -1):
        from .tenancy import FairQueue

        self.name = name
        self._lock = threading.Lock()
        self._replicas: List[Any] = []  # ActorHandles  # guarded-by: _lock
        self._ongoing: Dict[str, int] = {}  # actor-id hex -> count  # guarded-by: _lock
        self._draining: Set[str] = set()  # guarded-by: _lock
        self.max_ongoing = max_ongoing
        self.max_queued = max_queued  # -1 = unlimited
        # model-multiplex affinity: model_id -> MRU list of replica keys
        # (reference pow_2_scheduler.py is multiplex-aware the same way)
        self._affinity: Dict[str, List[str]] = {}  # guarded-by: _lock
        # weighted-fair parked dispatch: _TrackedCall records waiting for
        # ongoing headroom, granted in SCFQ order (FairQueue self-locks)
        self._parked = FairQueue()
        # recent release timestamps -> queue drain-rate Retry-After
        self._release_times: "deque[float]" = deque(maxlen=32)  # guarded-by: _lock
        # telemetry: per-deployment ongoing gauge
        _register_replica_set(self)

    def total_ongoing(self) -> int:
        """Requests currently in flight across this deployment's
        replicas (the router-side queue-depth signal)."""
        with self._lock:
            return sum(self._ongoing.values())

    _key = staticmethod(_rkey)

    def set_replicas(self, replicas: List[Any]) -> None:
        from ..core.config import cfg

        with self._lock:
            if not replicas and self._replicas:
                # an EMPTY membership computed while the head is down is
                # blindness, not death: keep dispatching on the cached
                # handles for the grace window; past it, believe it
                outage = _head_outage_s()
                if 0.0 < outage <= float(cfg.head_outage_grace_s):
                    logger.warning(
                        "deployment %r: ignoring empty replica membership during head "
                        "outage (%.1fs); serving on cached replicas", self.name, outage)
                    return
            self._replicas = list(replicas)
            # draining replicas keep their ongoing entries: the controller
            # watches them hit zero before killing the actor
            live = {self._key(r) for r in replicas} | self._draining
            self._ongoing = {k: v for k, v in self._ongoing.items() if k in live}
            for r in replicas:
                self._ongoing.setdefault(self._key(r), 0)
            # drop affinity for replicas that were swapped out
            for model_id in list(self._affinity):
                kept = [k for k in self._affinity[model_id] if k in live]
                if kept:
                    self._affinity[model_id] = kept
                else:
                    del self._affinity[model_id]

    def replicas(self) -> List[Any]:
        with self._lock:
            return list(self._replicas)

    # ------------------------------------------------------------- draining

    def mark_draining(self, key: str) -> None:
        with self._lock:
            self._draining.add(key)
            self._ongoing.setdefault(key, 0)
            self._replicas = [r for r in self._replicas if self._key(r) != key]

    def finish_draining(self, key: str) -> None:
        with self._lock:
            self._draining.discard(key)
            self._ongoing.pop(key, None)

    def ongoing_for(self, key: str) -> int:
        with self._lock:
            return self._ongoing.get(key, 0)

    # ----------------------------------------------------------------- pick

    def pick(self, model_id: Optional[str] = None, *,
             exclude: Optional[Set[str]] = None,
             admission: bool = True) -> Any:
        """Pow-2 choice by ongoing count; with a multiplexed model id,
        prefer a replica that already holds the model (affinity).

        exclude: replica keys a failover retry must avoid (the attempt
        that just failed there); relaxed when nothing else is alive.
        admission=False skips the queue bound (retries already held and
        released a slot — shedding them would double-count)."""
        with self._lock:
            routable = [
                r for r in self._replicas
                if self._key(r) not in self._draining
            ]
            if not routable:
                raise DeploymentUnavailableError(
                    f"deployment {self.name!r} has no routable replicas "
                    f"({len(self._draining)} draining)"
                )
            if admission and self.max_queued >= 0:
                ongoing = sum(
                    self._ongoing.get(self._key(r), 0) for r in routable
                )
                capacity = len(routable) * max(1, self.max_ongoing)
                if ongoing - capacity >= self.max_queued:
                    raise BackPressureError(
                        f"deployment {self.name!r} is overloaded: "
                        f"{ongoing} ongoing over {capacity} capacity "
                        f"(max_queued_requests={self.max_queued})"
                    )
            cands = routable
            if exclude:
                preferred = [r for r in routable if self._key(r) not in exclude]
                if preferred:
                    cands = preferred
            chosen = None
            if model_id:
                affine = [
                    r for r in cands
                    if self._key(r) in self._affinity.get(model_id, ())
                ]
                if affine:
                    chosen = min(
                        affine, key=lambda r: self._ongoing[self._key(r)]
                    )
            if chosen is None:
                if len(cands) == 1:
                    chosen = cands[0]
                else:
                    a, b = random.sample(cands, 2)
                    chosen = (
                        a
                        if self._ongoing[self._key(a)] <= self._ongoing[self._key(b)]
                        else b
                    )
            if model_id:
                mru = self._affinity.setdefault(model_id, [])
                ck = self._key(chosen)
                if ck in mru:
                    mru.remove(ck)
                mru.insert(0, ck)
                del mru[2:]  # at most 2 replicas per model keep affinity
            self._ongoing[self._key(chosen)] += 1
        if _head_outage_s() > 0.0:
            # dispatched on cached membership while the head is down
            _counter(
                "raytpu_serve_degraded_dispatch_total",
                "Requests dispatched while the GCS head was unreachable "
                "(served on cached replica membership).",
            ).inc()
        return chosen

    def release(self, replica: Any) -> None:
        self.release_key(self._key(replica))

    def release_key(self, key: str) -> None:
        with self._lock:
            if self._ongoing.get(key, 0) > 0:
                self._ongoing[key] -= 1
                # drain-rate sample for the Retry-After estimate
                self._release_times.append(time.monotonic())

    # --------------------------------------------------- parked dispatch

    def _dispatch_headroom(self) -> bool:
        """True when a routable replica has ongoing capacity to spare —
        the work-conserving fast path past the parked queue. With no
        routable replicas this reports True so callers reach pick() and
        get the typed DeploymentUnavailableError instead of parking."""
        with self._lock:
            routable = [
                r for r in self._replicas
                if self._key(r) not in self._draining
            ]
            if not routable:
                return True
            ongoing = sum(
                self._ongoing.get(self._key(r), 0) for r in routable
            )
            return ongoing < len(routable) * max(1, self.max_ongoing)

    def should_park(self) -> bool:
        """A resilient unary call must queue behind the weighted-fair
        parked dispatches when the deployment is at ongoing capacity, or
        when earlier arrivals are already parked (no barging past the
        fair queue)."""
        if self.max_ongoing <= 0:
            return False
        if len(self._parked):
            return True
        return not self._dispatch_headroom()

    def park_would_shed(self) -> bool:
        return 0 <= self.max_queued <= len(self._parked)

    def park(self, rec: Any, tenant: str, priority: int) -> None:
        self._parked.push(rec, tenant, priority)

    def try_grant(self, rec: Any) -> bool:
        """Reaper-side: pop `rec` from the parked queue iff it is the
        weighted-fair head AND a replica has headroom. The reaper calls
        this for every parked record each pass, so grants walk the queue
        strictly in fair order."""
        if not self._dispatch_headroom():
            return False
        return self._parked.pop_if_head(rec)

    def cancel_parked(self, rec: Any) -> bool:
        return self._parked.remove(rec)

    def parked_count(self) -> int:
        return len(self._parked)

    def drain_retry_after_s(self) -> Optional[float]:
        """Retry-After estimate from the recent release rate: roughly how
        long the current parked backlog takes to drain. None (-> the
        HTTP layers' 1s default) until enough completions are observed."""
        with self._lock:
            times = list(self._release_times)
        if len(times) < 2:
            return None
        span = times[-1] - times[0]
        if span <= 0:
            return None
        rate = (len(times) - 1) / span
        return min(60.0, max(1.0, (len(self._parked) + 1) / rate))



class DeploymentHandle:
    """What users call: handle.method.remote(args) → ObjectRef.
    options(stream=True) streams a
    generator method's yields; options(multiplexed_model_id=...) routes
    with model affinity; options(timeout_s=...) sets the request's
    end-to-end deadline (expired → typed RequestTimeoutError);
    options(max_retries=...) bounds router failover attempts."""

    def __init__(self, replica_set: ReplicaSet, *, stream: bool = False,
                 multiplexed_model_id: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 tenant: Optional[str] = None,
                 priority: Optional[int] = None,
                 request_id: Optional[str] = None):
        self._set = replica_set
        self._stream = stream
        self._model_id = multiplexed_model_id
        self._timeout_s = timeout_s
        self._max_retries = max_retries
        self._tenant = tenant
        self._priority = priority
        self._request_id = request_id

    def options(self, *, stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                timeout_s: Optional[float] = None,
                max_retries: Optional[int] = None,
                tenant: Optional[str] = None,
                priority: Optional[int] = None,
                request_id: Optional[str] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self._set,
            stream=self._stream if stream is None else stream,
            multiplexed_model_id=multiplexed_model_id or self._model_id,
            timeout_s=self._timeout_s if timeout_s is None else timeout_s,
            max_retries=(
                self._max_retries if max_retries is None else max_retries
            ),
            tenant=self._tenant if tenant is None else tenant,
            priority=self._priority if priority is None else priority,
            request_id=(
                self._request_id if request_id is None else request_id
            ),
        )

    def __getattr__(self, method: str) -> "_MethodCaller":
        if method.startswith("_"):
            raise AttributeError(method)
        return _MethodCaller(self._set, method, self._stream, self._model_id,
                             self._timeout_s, self._max_retries,
                             self._tenant, self._priority, self._request_id)

    def remote(self, *args, **kwargs):
        """Callable deployments: handle.remote(x) → instance.__call__(x)."""
        return _MethodCaller(
            self._set, "__call__", self._stream, self._model_id,
            self._timeout_s, self._max_retries, self._tenant, self._priority,
            self._request_id,
        ).remote(*args, **kwargs)

    @property
    def deployment_name(self) -> str:
        return self._set.name


def _mint_promise():
    """A router-owned future: the reaper seals the winning attempt's
    result (or the typed failure) into it, so the ref handed to the
    caller survives replica failover."""
    from ..core.ids import ObjectID
    from ..core.runtime import ObjectRef, get_runtime

    rt = get_runtime()
    oid = ObjectID.for_put(rt.job_id)
    rt.object_store.create(oid)
    return ObjectRef(oid, rt), oid, rt


class _FailoverStream(ObjectRefGenerator):
    """Router-owned stream that survives replica failover: the feeder
    thread copies item refs from successive attempt streams into it,
    skipping the prefix already delivered to the consumer."""

    def __init__(self, first_attempt: ObjectRefGenerator):
        super().__init__(first_attempt._task_id, first_attempt._runtime)

    def _append_ref(self, ref: Any) -> None:
        with self._cond:
            self._refs.append(ref)
            self._cond.notify_all()


class _MethodCaller:
    def __init__(self, replica_set: ReplicaSet, method: str,
                 stream: bool = False, model_id: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 tenant: Optional[str] = None,
                 priority: Optional[int] = None,
                 request_id: Optional[str] = None):
        self._set = replica_set
        self._method = method
        self._stream = stream
        self._model_id = model_id
        self._timeout_s = timeout_s
        self._max_retries = max_retries
        self._tenant = tenant
        self._priority = priority
        self._request_id = request_id

    def _resolve_request_id(self) -> Optional[str]:
        """The end-to-end forensics id for this call: the handle's
        explicit option wins, else the ambient id when this call happens
        inside another serve request (composition hop — the hops share
        one timeline), else a fresh id when the request log is on."""
        from . import context as serve_ctx

        rid = self._request_id
        if rid is None:
            rid = serve_ctx.get_request_id()
        if rid is None and reqlog.enabled():
            rid = reqlog.new_request_id()
        return rid

    def _resolve_tenant(self):
        """(tenant | None, priority | None) for this call: the handle's
        explicit options win, else the ambient request tenant when this
        call happens inside another serve request (composition hop) —
        the same inheritance rule the deadline follows."""
        from . import context as serve_ctx

        tenant = self._tenant
        if tenant is None:
            tenant = serve_ctx.get_request_tenant()
        priority = self._priority
        if priority is None:
            priority = serve_ctx.get_request_priority()
        return tenant, priority

    def _resolve_policy(self):
        """(deadline_ts | None, max_attempts >= 1) for this call.

        The deadline is the MIN of the handle's timeout_s (default:
        cfg.serve_default_timeout_s; 0 disables) and the ambient request
        deadline when this call happens inside another serve request
        (composition hop) — a downstream hop never outlives its parent."""
        from ..core.config import cfg
        from . import context as serve_ctx

        timeout_s = self._timeout_s
        if timeout_s is None:
            timeout_s = float(cfg.serve_default_timeout_s)
        deadline = time.time() + timeout_s if timeout_s > 0 else None
        ambient = serve_ctx.get_request_deadline()
        if ambient is not None:
            deadline = ambient if deadline is None else min(deadline, ambient)
        attempts = self._max_retries
        if attempts is None:
            attempts = int(cfg.serve_retry_max_attempts)
        return deadline, max(1, attempts)

    def remote(self, *args, **kwargs):
        from ..util import tracing
        from .tenancy import DEFAULT_TENANT

        deadline, max_attempts = self._resolve_policy()
        tenant, priority = self._resolve_tenant()
        request_id = self._resolve_request_id()
        resilient = max_attempts > 1 or deadline is not None
        # serve.route roots the request's trace (or nests, when called
        # from a traced region): replica pick + submission. The replica's
        # actor.call/actor.execute spans — and the engine's request span
        # inside it — parent in through the context propagation.
        with tracing.span(
            "serve.route", deployment=self._set.name, method=self._method,
            model_id=self._model_id or "",
        ) as route_span:
            if request_id is not None:
                route_span.set_attribute("request_id", request_id)
            reqlog.mark(request_id, "route.received", tenant=tenant,
                        deployment=self._set.name, method=self._method)
            if deadline is not None:
                route_span.set_attribute("deadline_ts", deadline)
                if time.time() >= deadline:
                    _counter(
                        "raytpu_serve_timeouts_total",
                        "serve requests failed on an expired deadline",
                    ).inc()
                    reqlog.mark(request_id, "route.timeout", tenant=tenant,
                                reason="expired_before_routing")
                    raise RequestTimeoutError(
                        f"request to {self._set.name!r}.{self._method} "
                        f"expired before routing"
                    )
            if self._model_id:
                kwargs["_multiplexed_model_id"] = self._model_id
            if deadline is not None:
                kwargs["_deadline_ts"] = deadline
            if tenant is not None:
                kwargs["_tenant"] = tenant
                route_span.set_attribute("tenant", tenant)
            if priority is not None:
                kwargs["_priority"] = priority
            if request_id is not None:
                kwargs["_request_id"] = request_id
            # At ongoing capacity, resilient unary calls PARK instead of
            # dispatching: the reaper grants parked records in weighted-
            # fair order as replicas free up, so overload dispatch is
            # weight-proportional per tenant rather than FIFO. Streams
            # and non-resilient calls keep the direct path (no promise to
            # park behind).
            if resilient and not self._stream and self._set.should_park():
                if self._set.park_would_shed():
                    from . import tenancy

                    _counter(
                        "raytpu_serve_shed_total",
                        "serve requests shed by admission control",
                    ).inc()
                    tenancy.count_shed(tenant or DEFAULT_TENANT)
                    route_span.set_attribute("shed", True)
                    retry_after = self._set.drain_retry_after_s()
                    reqlog.mark(request_id, "route.shed", tenant=tenant,
                                reason="parked_queue_full",
                                retry_after_s=retry_after)
                    raise BackPressureError(
                        f"deployment {self._set.name!r} is overloaded: "
                        f"{self._set.parked_count()} parked dispatches "
                        f"(max_queued_requests={self._set.max_queued})",
                        retry_after_s=retry_after,
                    )
                promise_ref, promise_oid, rt = _mint_promise()
                rec = _TrackedCall(
                    None, self._set, "", promise_oid, rt,
                    method=self._method, args=args, kwargs=kwargs,
                    model_id=self._model_id, deadline=deadline,
                    max_attempts=max_attempts,
                )
                rec.parked = True
                rec.attempts = 0  # first dispatch is attempt 1, not a retry
                self._set.park(rec, tenant or DEFAULT_TENANT, priority or 0)
                _Reaper.instance()._track_record(rec)
                route_span.set_attribute("parked", True)
                reqlog.mark(request_id, "route.parked", tenant=tenant,
                            parked=self._set.parked_count())
                return promise_ref
            try:
                replica = self._set.pick(self._model_id)
            except BackPressureError:
                _counter(
                    "raytpu_serve_shed_total",
                    "serve requests shed by admission control",
                ).inc()
                route_span.set_attribute("shed", True)
                reqlog.mark(request_id, "route.shed", tenant=tenant,
                            reason="ongoing_capacity")
                raise
            route_span.set_attribute("replica", _rkey(replica)[:12])
            try:
                # replicas are _ReplicaWrapper actors: dispatch by method name
                call = replica.call
                if self._stream:
                    call = call.options(num_returns="streaming")
                ref = call.remote(self._method, *args, **kwargs)
            except BaseException:
                self._set.release(replica)
                raise
            reqlog.mark(request_id, "route.dispatched", tenant=tenant,
                        replica=_rkey(replica)[:12], attempt=1)
        if self._stream:
            if not resilient:
                _Reaper.instance().track(ref, self._set, replica)
                return ref
            proxy = _FailoverStream(ref)
            feeder = threading.Thread(
                target=_stream_failover_loop,
                args=(proxy, self._set, self._model_id, self._method,
                      args, kwargs, replica, ref, deadline, max_attempts),
                daemon=True,
                name=f"serve-stream-{self._set.name}",
            )
            feeder.start()
            return proxy
        if not resilient:
            _Reaper.instance().track(ref, self._set, replica)
            return ref
        promise_ref, promise_oid, rt = _mint_promise()
        _Reaper.instance().track_failover(
            ref, self._set, replica, promise_oid, rt,
            method=self._method, args=args, kwargs=kwargs,
            model_id=self._model_id, deadline=deadline,
            max_attempts=max_attempts,
        )
        return promise_ref


def _stream_failover_loop(proxy: _FailoverStream, rset: ReplicaSet,
                          model_id: Optional[str], method: str,
                          args, kwargs, replica, stream,
                          deadline: Optional[float],
                          max_attempts: int) -> None:
    """Feeder thread for resilient streaming calls: copies item refs from
    the live attempt into the proxy; on a retryable mid-stream failure it
    re-picks a different replica, replays the generator, and skips the
    prefix the consumer already saw. Deadline expiry fails the stream
    with RequestTimeoutError (the engine cancels its slot on its own)."""
    delivered = 0
    attempts = 1
    skip = 0
    key = _rkey(replica)
    while True:
        try:
            while True:
                if proxy._abandoned:
                    rset.release_key(key)
                    return
                timeout = None
                if deadline is not None:
                    timeout = deadline - time.time()
                    if timeout <= 0:
                        raise GetTimeoutError("stream deadline expired")
                try:
                    ref = stream.next_ready(timeout=timeout)
                except StopIteration:
                    rset.release_key(key)
                    proxy._finish()
                    return
                if skip > 0:
                    skip -= 1  # replayed prefix: consumer already has it
                    continue
                proxy._append_ref(ref)
                delivered += 1
        except BaseException as err:  # noqa: BLE001 - classified below
            rset.release_key(key)
            cause = unwrap_error(err)
            if isinstance(cause, (GetTimeoutError, RequestTimeoutError)):
                _counter(
                    "raytpu_serve_timeouts_total",
                    "serve requests failed on an expired deadline",
                ).inc()
                _mark_route(kwargs, "route.timeout",
                            reason="stream_deadline", delivered=delivered)
                proxy._finish(RequestTimeoutError(
                    f"stream from {rset.name!r}.{method} exceeded its "
                    f"deadline after {delivered} items"
                ))
                return
            if attempts >= max_attempts or not isinstance(cause, _RETRYABLE):
                _mark_route(kwargs, "route.failed",
                            error=type(cause).__name__, attempts=attempts)
                proxy._finish(err)
                return
            wait = _retry_backoff_s(attempts)
            if deadline is not None and time.time() + wait >= deadline:
                _counter(
                    "raytpu_serve_timeouts_total",
                    "serve requests failed on an expired deadline",
                ).inc()
                _mark_route(kwargs, "route.timeout",
                            reason="no_retry_budget", delivered=delivered)
                proxy._finish(RequestTimeoutError(
                    f"stream from {rset.name!r}.{method}: no retry budget "
                    f"left before the deadline"
                ))
                return
            time.sleep(wait)
            try:
                replica = rset.pick(model_id, exclude={key}, admission=False)
            except BaseException:
                _mark_route(kwargs, "route.failed",
                            error=type(cause).__name__, attempts=attempts)
                proxy._finish(err)
                return
            key = _rkey(replica)
            attempts += 1
            _counter(
                "raytpu_serve_failovers_total",
                "serve requests failed over to a different replica",
            ).inc()
            _mark_route(kwargs, "route.failover",
                        error=type(cause).__name__, attempt=attempts)
            try:
                stream = replica.call.options(num_returns="streaming").remote(
                    method, *args, **kwargs
                )
            except BaseException as sub_err:  # noqa: BLE001
                rset.release_key(key)
                _mark_route(kwargs, "route.failed",
                            error=type(sub_err).__name__, attempts=attempts)
                proxy._finish(sub_err)
                return
            _mark_route(kwargs, "route.dispatched", replica=key[:12],
                        attempt=attempts)
            skip = delivered


class _TrackedCall:
    """One router-tracked request: either a plain ref (release-on-done)
    or a failover call with a promise the reaper must eventually seal."""

    __slots__ = (
        "ref", "rset", "key", "promise_oid", "runtime", "method", "args",
        "kwargs", "model_id", "deadline", "max_attempts", "attempts",
        "failed_keys", "next_retry_ts", "last_error", "parked",
    )

    def __init__(self, ref, rset, key, promise_oid=None, runtime=None,
                 method=None, args=(), kwargs=None, model_id=None,
                 deadline=None, max_attempts=1):
        self.ref = ref
        self.rset = rset
        self.key = key
        self.promise_oid = promise_oid
        self.runtime = runtime
        self.method = method
        self.args = args
        self.kwargs = kwargs or {}
        self.model_id = model_id
        self.deadline = deadline
        self.max_attempts = max_attempts
        self.attempts = 1
        self.failed_keys: Set[str] = set()
        self.next_retry_ts: Optional[float] = None
        self.last_error: Optional[BaseException] = None
        # waiting in the rset's weighted-fair parked queue for dispatch
        # headroom (ref is None until the reaper grants + dispatches)
        self.parked = False


class _Reaper:
    """Request-lifecycle owner on the router side: one background thread
    that (a) releases ongoing counts when request refs complete — success
    OR error, so failed calls stop skewing least-loaded picks, (b) drives
    failover resubmission with jittered backoff onto a different replica,
    (c) enforces deadlines by sealing RequestTimeoutError into the
    promise, and (d) caps its tracked list so one stuck ref can't grow it
    unboundedly (overflow releases + fails the oldest entry and bumps
    raytpu_serve_reaper_overflow_total)."""

    _inst: Optional["_Reaper"] = None  # guarded-by: _inst_lock
    _inst_lock = threading.Lock()

    def __init__(self):
        from ..util.metrics import get_or_create_gauge

        self._lock = threading.Lock()
        self._tracked: List[_TrackedCall] = []  # guarded-by: _lock
        self._event = threading.Event()
        self._stopping = False
        self._overflow_warned = False
        get_or_create_gauge(
            "raytpu_serve_reaper_tracked",
            "request refs currently tracked by the serve reaper",
            fn=lambda: float(len(self._tracked)),
        )
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serve-reaper")
        self._thread.start()

    @classmethod
    def instance(cls) -> "_Reaper":
        with cls._inst_lock:
            if cls._inst is None:
                cls._inst = cls()
            return cls._inst

    @classmethod
    def shutdown(cls, timeout: float = 5.0) -> None:
        """Stop the reaper thread and join it (serve.shutdown). Requests
        it still tracks fail with DeploymentUnavailableError, so no
        caller waits on a promise nobody will seal; the next tracked
        request starts a new reaper."""
        with cls._inst_lock:
            inst, cls._inst = cls._inst, None
        if inst is None:
            return
        inst._stopping = True
        inst._event.set()
        inst._thread.join(timeout)
        with inst._lock:
            left, inst._tracked = inst._tracked, []
        for rec in left:
            rec.rset.release_key(rec.key)
            inst._seal_error(rec, DeploymentUnavailableError(
                f"serve shut down with the request to {rec.rset.name!r} in flight"
            ))

    # ------------------------------------------------------------- tracking

    def track(self, ref, replica_set, replica) -> None:
        self._track_record(
            _TrackedCall(ref, replica_set, _rkey(replica))
        )

    def track_failover(self, ref, replica_set, replica, promise_oid, runtime,
                       *, method, args, kwargs, model_id, deadline,
                       max_attempts) -> None:
        self._track_record(_TrackedCall(
            ref, replica_set, _rkey(replica), promise_oid, runtime,
            method=method, args=args, kwargs=kwargs, model_id=model_id,
            deadline=deadline, max_attempts=max_attempts,
        ))

    def _track_record(self, rec: _TrackedCall) -> None:
        from ..core.config import cfg

        overflow = None
        with self._lock:
            cap = int(cfg.serve_reaper_max_tracked)
            if cap > 0 and len(self._tracked) >= cap:
                overflow = self._tracked.pop(0)
            self._tracked.append(rec)
        self._event.set()
        if overflow is not None:
            if overflow.parked:
                # never leave a dropped record wedged at the fair head
                overflow.rset.cancel_parked(overflow)
            overflow.rset.release_key(overflow.key)
            _mark_route(overflow.kwargs, "route.failed",
                        reason="reaper_overflow")
            self._seal_error(overflow, RuntimeError(
                "serve reaper overflow: request dropped to bound tracking "
                f"(serve_reaper_max_tracked={cfg.serve_reaper_max_tracked})"
            ))
            _counter(
                "raytpu_serve_reaper_overflow_total",
                "tracked requests dropped by the reaper's size cap",
            ).inc()
            if not self._overflow_warned:
                self._overflow_warned = True
                logger.warning(
                    "serve reaper hit its tracked-ref cap (%d); oldest "
                    "request dropped — a replica is likely stuck",
                    cap,
                )

    # ----------------------------------------------------------- seal paths

    @staticmethod
    def _seal(rec: _TrackedCall, value: Any) -> None:
        if rec.promise_oid is not None:
            try:
                rec.runtime.object_store.seal(rec.promise_oid, value)
            except Exception:
                logger.exception("reaper failed to seal promise")

    @staticmethod
    def _seal_error(rec: _TrackedCall, err: BaseException) -> None:
        if rec.promise_oid is not None:
            try:
                rec.runtime.object_store.seal_error(rec.promise_oid, err)
            except Exception:
                logger.exception("reaper failed to seal promise error")

    # ----------------------------------------------------------------- loop

    def _loop(self) -> None:
        while not self._stopping:
            with self._lock:
                tracked = list(self._tracked)
            if not tracked:
                self._event.clear()
                if not self._stopping:
                    self._event.wait()
                continue
            # Block until SOME in-flight ref completes (api.wait returns
            # on the first completion, so request latency is not gated on
            # the poll cadence); the bounded timeout keeps deadline and
            # backoff bookkeeping ticking and picks up newly tracked refs.
            inflight = [
                rec.ref for rec in tracked
                if rec.ref is not None
                and not isinstance(rec.ref, ObjectRefGenerator)
            ]
            if inflight:
                try:
                    api.wait(inflight, num_returns=1, timeout=0.02)
                except BaseException:  # noqa: BLE001 - torn refs handled below
                    time.sleep(0.005)
            else:
                self._event.wait(timeout=0.02)
                self._event.clear()
            with self._lock:
                tracked = list(self._tracked)
            done: List[_TrackedCall] = []
            for rec in tracked:
                try:
                    if self._advance(rec):
                        done.append(rec)
                except Exception:
                    logger.exception("serve reaper: tracking entry failed")
                    rec.rset.release_key(rec.key)
                    self._seal_error(rec, RuntimeError("serve reaper error"))
                    done.append(rec)
            if done:
                done_ids = {id(r) for r in done}
                with self._lock:
                    self._tracked = [
                        r for r in self._tracked if id(r) not in done_ids
                    ]

    def _advance(self, rec: _TrackedCall) -> bool:
        """Step one tracked call; True = finished, drop it."""
        now = time.time()
        if rec.parked:
            # waiting for dispatch headroom in the rset's weighted-fair
            # queue (only this reaper thread grants/cancels, so there is
            # no pop race with other mutators — park() only pushes)
            if rec.deadline is not None and now >= rec.deadline:
                rec.rset.cancel_parked(rec)
                _counter(
                    "raytpu_serve_timeouts_total",
                    "serve requests failed on an expired deadline",
                ).inc()
                _mark_route(rec.kwargs, "route.timeout",
                            reason="parked_deadline")
                self._seal_error(rec, RequestTimeoutError(
                    f"request to {rec.rset.name!r}.{rec.method} exceeded "
                    f"its deadline while parked for dispatch"
                ))
                return True
            if not rec.rset.try_grant(rec):
                return False
            rec.parked = False
            _mark_route(rec.kwargs, "route.granted")
            return self._dispatch_parked(rec)
        # deadline enforcement (promise-backed calls fail fast; plain
        # tracked refs have no promise to seal, their caller owns timeouts)
        if (
            rec.promise_oid is not None
            and rec.deadline is not None
            and now >= rec.deadline
        ):
            rec.rset.release_key(rec.key)
            _counter(
                "raytpu_serve_timeouts_total",
                "serve requests failed on an expired deadline",
            ).inc()
            _mark_route(rec.kwargs, "route.timeout", reason="deadline",
                        attempt=rec.attempts)
            self._seal_error(rec, RequestTimeoutError(
                f"request to {rec.rset.name!r}.{rec.method} exceeded its "
                f"deadline (attempt {rec.attempts}/{rec.max_attempts})"
            ))
            return True
        if rec.next_retry_ts is not None:
            if now < rec.next_retry_ts:
                return False
            return self._resubmit(rec)
        # completion check: streams complete on their flag; refs on seal
        if isinstance(rec.ref, ObjectRefGenerator):
            if not rec.ref.completed():
                return False
            rec.rset.release_key(rec.key)
            return True
        try:
            ready = rec.ref.is_ready()
        except Exception:
            ready = True  # a torn ref must not pin the replica forever
        if not ready:
            return False
        if rec.promise_oid is None:
            rec.rset.release_key(rec.key)
            return True
        try:
            value = api.get(rec.ref, timeout=1.0)
        except BaseException as err:  # noqa: BLE001 - classified below
            return self._on_error(rec, err)
        rec.rset.release_key(rec.key)
        self._seal(rec, value)
        return True

    def _on_error(self, rec: _TrackedCall, err: BaseException) -> bool:
        rec.rset.release_key(rec.key)
        rec.failed_keys.add(rec.key)
        rec.last_error = err
        now = time.time()
        wait = _retry_backoff_s(rec.attempts)
        can_retry = (
            rec.attempts < rec.max_attempts
            and _retryable(err)
            and (rec.deadline is None or now + wait < rec.deadline)
        )
        if not can_retry:
            _mark_route(rec.kwargs, "route.failed",
                        error=type(unwrap_error(err)).__name__,
                        attempts=rec.attempts)
            self._seal_error(rec, err)
            return True
        rec.next_retry_ts = now + wait
        rec.ref = None
        _counter(
            "raytpu_serve_retries_total",
            "serve request attempts retried after a replica failure",
        ).inc()
        return False

    def _dispatch_parked(self, rec: _TrackedCall) -> bool:
        """First dispatch of a WFQ-granted parked call: mirrors _resubmit
        minus the failover counter — a park is queueing, not a retry.
        admission=False: the call already passed the shed check at park
        time, and the grant itself consumed the headroom it saw."""
        try:
            replica = rec.rset.pick(
                rec.model_id, exclude=rec.failed_keys, admission=False
            )
        except BaseException as pick_err:  # noqa: BLE001
            # nothing routable right now (controller may be restarting
            # replicas): burn one attempt waiting, or give up
            rec.attempts += 1
            now = time.time()
            wait = _retry_backoff_s(rec.attempts)
            if (
                rec.attempts < rec.max_attempts
                and (rec.deadline is None or now + wait < rec.deadline)
            ):
                rec.next_retry_ts = now + wait
                return False
            _mark_route(rec.kwargs, "route.failed", reason="no_replica",
                        attempts=rec.attempts)
            self._seal_error(rec, rec.last_error or pick_err)
            return True
        rec.key = _rkey(replica)
        rec.attempts += 1
        try:
            rec.ref = replica.call.remote(rec.method, *rec.args, **rec.kwargs)
        except BaseException as err:  # noqa: BLE001
            return self._on_error(rec, err)
        _mark_route(rec.kwargs, "route.dispatched", replica=rec.key[:12],
                    attempt=rec.attempts)
        return False

    def _resubmit(self, rec: _TrackedCall) -> bool:
        rec.next_retry_ts = None
        try:
            replica = rec.rset.pick(
                rec.model_id, exclude=rec.failed_keys, admission=False
            )
        except BaseException as pick_err:  # noqa: BLE001
            # nothing routable right now (controller may still be
            # restarting replicas): burn one attempt waiting, or give up
            rec.attempts += 1
            now = time.time()
            wait = _retry_backoff_s(rec.attempts)
            if (
                rec.attempts < rec.max_attempts
                and (rec.deadline is None or now + wait < rec.deadline)
            ):
                rec.next_retry_ts = now + wait
                return False
            _mark_route(rec.kwargs, "route.failed", reason="no_replica",
                        attempts=rec.attempts)
            self._seal_error(rec, rec.last_error or pick_err)
            return True
        rec.key = _rkey(replica)
        rec.attempts += 1
        _counter(
            "raytpu_serve_failovers_total",
            "serve requests failed over to a different replica",
        ).inc()
        _mark_route(rec.kwargs, "route.failover", attempt=rec.attempts)
        try:
            rec.ref = replica.call.remote(rec.method, *rec.args, **rec.kwargs)
        except BaseException as err:  # noqa: BLE001
            return self._on_error(rec, err)
        _mark_route(rec.kwargs, "route.dispatched", replica=rec.key[:12],
                    attempt=rec.attempts)
        return False
