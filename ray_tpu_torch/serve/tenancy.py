"""Multi-tenant serve plane: tenant registry, weighted-fair queueing,
token-bucket quotas, and per-tenant TTFT windows.

Port of `ray_tpu/serve/tenancy.py`, host-only Python copied into the port
(which imports nothing of `ray_tpu`):

- **TenantSpec registry** — weight (fair share), priority (preemption
  eligibility and strict queue tiers), token-bucket quota (rate/burst) and
  a per-tenant TTFT objective.
- **FairQueue** — priority-tiered start-time fair queueing (SCFQ), the
  paged engine's admit queue.
- **Token buckets** — per-tenant rate limiting applied at engine
  admission; a shed raises the typed ``BackPressureError`` carrying the
  bucket's actual refill time.
- **TTFT windows** — engines report each request's time to first token
  and its decomposition here; ``ServeSLOMonitor`` (util/watchdog.py)
  drains the windows every check period and keeps per-tenant attainment
  gauges and burn.

- **HTTP surfacing** — `resolve_http_tenant` reads the tenant from the
  ``cfg.serve_tenant_header`` header or a registered API key, and the
  priority from ``x-priority``, for the serve proxy and the OpenAI
  frontend.

`count_shed` and `count_request` feed the per-tenant
``raytpu_serve_tenant_shed_total`` / ``raytpu_serve_tenant_requests_total``
counters, and a shed emits a rate-limited ``serve.shed`` event.

The registry is module-level, as in the JAX package: engines in one
process share it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..core.config import cfg

DEFAULT_TENANT = "default"


# ---------------------------------------------------------------------------
# tenant registry


@dataclass
class TenantSpec:
    """Declared shape of one tenant. Zero/negative sentinel fields fall
    back to the fleet-wide config defaults at read time (``weight_of`` /
    ``_effective_quota`` / ``ttft_objective``)."""

    name: str
    weight: float = 0.0        # 0 = cfg.serve_tenant_default_weight
    priority: int = 0          # preemption tier; higher preempts lower
    quota_rps: float = -1.0    # -1 = cfg.serve_tenant_quota_rps; 0 = unlimited
    quota_burst: float = 0.0   # 0 = auto (max(1, 2x rate))
    ttft_slo_s: float = 0.0    # 0 = cfg.serve_slo_ttft_p99_s


class _TokenBucket:
    """Classic token bucket: ``acquire()`` returns None when a token was
    available (request admitted) or the seconds until one token refills —
    the honest Retry-After a shed should carry."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._lock = threading.Lock()
        self._tokens = float(burst)  # guarded-by: _lock
        self._stamp = time.monotonic()  # guarded-by: _lock

    def acquire(self) -> Optional[float]:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst, self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return None
            if self.rate <= 0:
                return 1.0
            return (1.0 - self._tokens) / self.rate


_lock = threading.Lock()
_specs: Dict[str, TenantSpec] = {}  # guarded-by: _lock
_buckets: Dict[str, _TokenBucket] = {}  # guarded-by: _lock
_ttft_window: Dict[str, List[float]] = {}  # guarded-by: _lock
_ttft_breakdown: Dict[str, List[Dict[str, float]]] = {}  # guarded-by: _lock
_queue_wait_window: Dict[str, List[float]] = {}  # guarded-by: _lock
_last_shed_event: Dict[str, float] = {}  # guarded-by: _lock
_api_keys: Dict[str, str] = {}  # guarded-by: _lock


def set_tenant(
    name: str,
    *,
    weight: Optional[float] = None,
    priority: Optional[int] = None,
    quota_rps: Optional[float] = None,
    quota_burst: Optional[float] = None,
    ttft_slo_s: Optional[float] = None,
    api_key: Optional[str] = None,
) -> TenantSpec:
    """Declare (or update) a tenant. Unspecified fields keep their
    previous value; a tenant never has to be declared to send traffic —
    undeclared tenants get the config defaults. `api_key` registers an
    ``Authorization: Bearer <key>`` token that resolves to this tenant
    on the HTTP frontends."""
    with _lock:
        spec_obj = _specs.get(name) or TenantSpec(name=name)
        if weight is not None:
            spec_obj.weight = float(weight)
        if priority is not None:
            spec_obj.priority = int(priority)
        if quota_rps is not None:
            spec_obj.quota_rps = float(quota_rps)
        if quota_burst is not None:
            spec_obj.quota_burst = float(quota_burst)
        if ttft_slo_s is not None:
            spec_obj.ttft_slo_s = float(ttft_slo_s)
        if api_key is not None:
            _api_keys[api_key] = name
        _specs[name] = spec_obj
        # quota changed: rebuild the bucket lazily on next check
        _buckets.pop(name, None)
        return spec_obj


def spec(name: str) -> TenantSpec:
    with _lock:
        return _specs.get(name) or TenantSpec(name=name)


def reset() -> None:
    """Drop all declared tenants, buckets, API keys, and TTFT windows
    (test isolation)."""
    with _lock:
        for table in (_specs, _buckets, _ttft_window, _ttft_breakdown,
                      _queue_wait_window, _last_shed_event, _api_keys):
            table.clear()


def weight_of(tenant: str) -> float:
    with _lock:
        spec_obj = _specs.get(tenant)
    w = spec_obj.weight if spec_obj is not None else 0.0
    if w <= 0:
        w = float(cfg.serve_tenant_default_weight) or 1.0
    return max(w, 1e-6)


def priority_of(tenant: str) -> int:
    with _lock:
        spec_obj = _specs.get(tenant)
    return spec_obj.priority if spec_obj is not None else 0


def ttft_objective(tenant: str) -> float:
    with _lock:
        spec_obj = _specs.get(tenant)
    slo = spec_obj.ttft_slo_s if spec_obj is not None else 0.0
    if slo <= 0:
        slo = float(cfg.serve_slo_ttft_p99_s)
    return slo


def any_tenant_slo() -> bool:
    """True when at least one declared tenant carries its own TTFT
    objective (the SLO monitor must run even if fleet SLOs are off)."""
    with _lock:
        return any(s.ttft_slo_s > 0 for s in _specs.values())


# ---------------------------------------------------------------------------
# quotas


def _effective_quota(tenant: str) -> Tuple[float, float]:
    with _lock:
        spec_obj = _specs.get(tenant)
    rate = spec_obj.quota_rps if spec_obj is not None else -1.0
    if rate < 0:
        rate = float(cfg.serve_tenant_quota_rps)
    # as in the JAX package, an unset burst is 2x the rate; the registry's
    # serve_tenant_quota_burst is not read here (nor there)
    burst = spec_obj.quota_burst if spec_obj is not None else 0.0
    if burst <= 0:
        burst = max(1.0, 2.0 * rate)
    return rate, burst


def quota_check(tenant: str) -> Optional[float]:
    """Charge one request against the tenant's token bucket. Returns None
    when admitted, else the seconds until a token refills (the computed
    Retry-After). A zero rate means unlimited."""
    rate, burst = _effective_quota(tenant)
    if rate <= 0:
        return None
    with _lock:
        bucket = _buckets.get(tenant)
        if bucket is None or bucket.rate != rate or bucket.burst != burst:
            bucket = _TokenBucket(rate, burst)
            _buckets[tenant] = bucket
    return bucket.acquire()


def count_shed(tenant: str, retry_after_s: Optional[float] = None) -> None:
    """Attribute one shed to the tenant: per-tenant counter plus a
    rate-limited serve.shed event (at most one per tenant per second so a
    flooding tenant cannot flood the flight recorder too)."""
    from ..util.events import emit
    from ..util.metrics import get_or_create_counter

    get_or_create_counter(
        "raytpu_serve_tenant_shed_total",
        "Requests shed by admission control, by tenant.",
        tag_keys=("tenant",),
    ).inc(tags={"tenant": tenant})
    now = time.monotonic()
    with _lock:
        last = _last_shed_event.get(tenant, 0.0)
        if now - last < 1.0:
            return
        _last_shed_event[tenant] = now
    emit(
        "WARNING",
        "serve",
        f"shedding tenant {tenant!r} (retry_after_s={retry_after_s})",
        kind="serve.shed",
        tenant=tenant,
        retry_after_s=retry_after_s,
    )


def count_request(tenant: str) -> None:
    """Attribute one admitted request to the tenant."""
    from ..util.metrics import get_or_create_counter

    get_or_create_counter(
        "raytpu_serve_tenant_requests_total",
        "Requests admitted to an engine, by tenant.",
        tag_keys=("tenant",),
    ).inc(tags={"tenant": tenant})


# ---------------------------------------------------------------------------
# per-tenant TTFT windows


def observe_ttft(tenant: str, ttft_s: float) -> None:
    """Engines call this at first token; a monitor drains the window.
    Bounded per tenant so a monitor that never runs cannot leak."""
    with _lock:
        window = _ttft_window.setdefault(tenant, [])
        if len(window) < 100_000:
            window.append(float(ttft_s))


def drain_ttft_window() -> Dict[str, List[float]]:
    with _lock:
        out = _ttft_window.copy()
        _ttft_window.clear()
    return out


def observe_ttft_breakdown(tenant: str, buckets: Dict[str, float]) -> None:
    """Record one request's TTFT decomposition (engine._ttft_buckets:
    queue_wait / preempt_wait / prefill_compute, summing to TTFT). Same
    bound and drain cadence as the plain TTFT window."""
    with _lock:
        window = _ttft_breakdown.setdefault(tenant, [])
        if len(window) < 100_000:
            window.append(dict(buckets))
        qw = _queue_wait_window.setdefault(tenant, [])
        if len(qw) < 100_000:
            qw.append(float(buckets.get("queue_wait_s", 0.0)))


def drain_ttft_breakdown() -> Dict[str, List[Dict[str, float]]]:
    with _lock:
        out = _ttft_breakdown.copy()
        _ttft_breakdown.clear()
    return out


def drain_queue_wait_window() -> Dict[str, List[float]]:
    """Per-tenant queue-wait samples (the queue_wait_s bucket of each
    first token)."""
    with _lock:
        out = _queue_wait_window.copy()
        _queue_wait_window.clear()
    return out


# ---------------------------------------------------------------------------
# HTTP surfacing


def resolve_http_tenant(headers: Any) -> Tuple[Optional[str], Optional[int]]:
    """Resolve (tenant, priority) from HTTP request headers: the tenant
    header (cfg.serve_tenant_header, default 'x-tenant') wins, else an
    'Authorization: Bearer <key>' token registered via
    set_tenant(api_key=...). Priority comes from 'x-priority' or the
    tenant's declared spec."""
    tenant = headers.get(cfg.serve_tenant_header) if headers is not None else None
    if not tenant:
        auth = headers.get("Authorization") if headers is not None else None
        if auth and auth.lower().startswith("bearer "):
            key = auth[7:].strip()
            with _lock:
                tenant = _api_keys.get(key)
    priority: Optional[int] = None
    raw = headers.get("x-priority") if headers is not None else None
    if raw is not None:
        try:
            priority = int(raw)
        except (TypeError, ValueError):
            priority = None
    if tenant and priority is None:
        priority = priority_of(tenant)
    return tenant or None, priority


# ---------------------------------------------------------------------------
# weighted-fair queueing


class FairQueue:
    """Priority-tiered, weighted-fair queue (start-time fair queueing /
    SCFQ, per Golestani '94). Items land in a per-(priority, tenant)
    lane; each push stamps a virtual finish tag
    ``F = max(V_tier, F_lane) + cost/weight``. Pop serves the highest
    priority tier that has items; within the tier, the lane whose head
    carries the smallest finish tag wins, and the tier's virtual clock
    advances to that tag.

    - **weight-proportional**: a tenant with weight w accrues virtual
      time at 1/w per item, so sustained backlogs drain in proportion to
      the weights;
    - **starvation-free within a tier**: a flooding tenant's lane races
      ahead in virtual time and defers to lighter lanes;
    - **work-conserving**: an idle lane restarts at the tier's current
      virtual clock, and pop never returns None while any lane has items.

    Thread-safe; every mutation is under ``_lock``. ``requeue`` returns
    a previously-popped item to the *front* of its lane without a fresh
    virtual-time charge — deferred admissions (page stalls, preempted
    lanes) keep their place instead of paying twice.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lanes: Dict[Tuple[int, str], deque] = {}  # guarded-by: _lock
        self._finish: Dict[Tuple[int, str], float] = {}  # guarded-by: _lock
        self._vtime: Dict[int, float] = {}  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock

    def push(self, item: Any, tenant: str = DEFAULT_TENANT, priority: int = 0,
             weight: Optional[float] = None, cost: float = 1.0) -> None:
        w = float(weight) if weight is not None and weight > 0 else weight_of(tenant)
        key = (int(priority), str(tenant))
        with self._lock:
            vtime = self._vtime.get(key[0], 0.0)
            start = max(vtime, self._finish.get(key, 0.0))
            fin = start + float(cost) / w
            self._finish[key] = fin
            self._lanes.setdefault(key, deque()).append((fin, item))
            self._count += 1

    def requeue(self, item: Any, tenant: str = DEFAULT_TENANT, priority: int = 0) -> None:
        key = (int(priority), str(tenant))
        with self._lock:
            lane = self._lanes.setdefault(key, deque())
            fin = lane[0][0] if lane else self._vtime.get(key[0], 0.0)
            lane.appendleft((fin, item))
            self._count += 1

    def _head_key(self) -> Optional[Tuple[int, str]]:  # holds-lock: _lock
        best_rank = None
        best_key = None
        for key, lane in self._lanes.items():
            if not lane:
                continue
            rank = (-key[0], lane[0][0])
            if best_rank is None or rank < best_rank:
                best_rank, best_key = rank, key
        return best_key

    def peek(self) -> Optional[Any]:
        with self._lock:
            key = self._head_key()
            return self._lanes[key][0][1] if key is not None else None

    def pop(self) -> Optional[Any]:
        with self._lock:
            key = self._head_key()
            if key is None:
                return None
            return self._pop_from(key)

    def _pop_from(self, key: Tuple[int, str]) -> Any:  # holds-lock: _lock
        fin, item = self._lanes[key].popleft()
        if not self._lanes[key]:
            del self._lanes[key]
            # a drained lane's stale finish tag only matters until the
            # tier clock passes it; drop it then to bound the dict
            if self._finish.get(key, 0.0) <= self._vtime.get(key[0], 0.0):
                self._finish.pop(key, None)
        tier = key[0]
        self._vtime[tier] = max(self._vtime.get(tier, 0.0), fin)
        self._count -= 1
        return item

    def pop_if_head(self, item: Any) -> bool:
        """Pop and return True iff `item` is the current weighted-fair
        head (identity comparison)."""
        with self._lock:
            key = self._head_key()
            if key is None or self._lanes[key][0][1] is not item:
                return False
            self._pop_from(key)
            return True

    def remove(self, item: Any) -> bool:
        with self._lock:
            for key, lane in self._lanes.items():
                for entry in lane:
                    if entry[1] is item:
                        lane.remove(entry)
                        self._count -= 1
                        if not lane:
                            del self._lanes[key]
                        return True
        return False

    def drain(self) -> List[Any]:
        """Pop everything in fair order (engine-death and shutdown paths)."""
        out = []
        while True:
            item = self.pop()
            if item is None:
                return out
            out.append(item)

    def depths(self) -> List[Dict[str, Any]]:
        """Per-lane queue depths for engine introspection
        (``engine.snapshot()``): one row per occupied (priority, tenant)
        lane, highest priority first."""
        with self._lock:
            rows = [{"priority": key[0], "tenant": key[1], "depth": len(lane)}
                    for key, lane in self._lanes.items() if lane]
        rows.sort(key=lambda r: (-r["priority"], r["tenant"]))
        return rows

    def __len__(self) -> int:
        with self._lock:
            return self._count
