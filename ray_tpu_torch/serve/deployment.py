"""Deployment API: @serve.deployment → Deployment → .bind() → Application.

A copy of `ray_tpu/serve/deployment.py`: the deployment decorator, its
config (replicas, ongoing and queued bounds, drain, health probes,
autoscaling) and the binding of constructor arguments into an
Application.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    """Scale on ongoing requests: target = ceil(ongoing /
    target_ongoing_requests), clamped to [min_replicas, max_replicas];
    scale-down is damped by scale_down_delay_s and rides the graceful
    drain path.

    With slo_driven=True the controller additionally reads the
    ServeSLOMonitor attainment ledger each pass: new SLO-violating
    windows (TTFT/queue p99 over objective) bump the target by one
    replica — beyond what the ongoing-count heuristic asks for — as long
    as there is real demand pressure (cfg.autoscale_pressure_floor), and
    scale-down stays damped through scale_down_delay_s and the graceful
    drain path. Thresholds live on cfg (autoscale_burn_windows,
    autoscale_pressure_floor)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    interval_s: float = 0.5
    scale_down_delay_s: float = 2.0
    slo_driven: bool = False


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    # admission control: requests beyond (replicas x max_ongoing_requests)
    # + max_queued_requests are SHED at the router with a typed
    # BackPressureError (HTTP layers map it to 429 + Retry-After).
    # -1 = unlimited queueing (the pre-resilience behavior).
    max_queued_requests: int = -1
    # graceful scale-down/redeploy: a removed replica goes DRAINING (no
    # new requests routed) and gets this long to finish in-flight work
    # before the controller force-kills it. 0 = kill immediately.
    drain_timeout_s: float = 10.0
    autoscaling: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 1.0
    # probe budget for a RUNNING replica (reference
    # health_check_timeout_s); slow first-capture models need headroom
    health_check_timeout_s: float = 30.0
    # a replica whose __init__ is still running (e.g. loading weights or
    # capturing graphs on the card) is NOT unhealthy: give it this long before
    # health probes can prune it (readiness vs liveness)
    startup_grace_s: float = 180.0
    resources_per_replica: Optional[Dict[str, float]] = None
    max_restarts: int = 3


class Deployment:
    """A configured (but not yet deployed) class."""

    def __init__(self, cls: type, name: str, config: DeploymentConfig):
        self.cls = cls
        self.name = name
        self.config = config

    def options(self, **overrides) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        name = overrides.pop("name", self.name)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise TypeError(f"unknown deployment option {k!r}")
            setattr(cfg, k, v)
        return Deployment(self.cls, name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


@dataclasses.dataclass
class Application:
    """A deployment bound to its constructor args (a 1-node graph; handle
    args may themselves be Applications → composition)."""

    deployment: Deployment
    init_args: Tuple[Any, ...]
    init_kwargs: Dict[str, Any]


def deployment(
    cls: Optional[type] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_ongoing_requests: int = 8,
    max_queued_requests: int = -1,
    drain_timeout_s: float = 10.0,
    autoscaling: Optional[AutoscalingConfig] = None,
    resources_per_replica: Optional[Dict[str, float]] = None,
    max_restarts: int = 3,
) -> Any:
    """@serve.deployment decorator.

    max_queued_requests bounds router-side queueing (overflow sheds with
    BackPressureError → HTTP 429); drain_timeout_s is the grace a
    replica gets to finish in-flight requests on scale-down/redeploy.
    """

    def wrap(c: type) -> Deployment:
        config = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            drain_timeout_s=drain_timeout_s,
            autoscaling=autoscaling,
            resources_per_replica=resources_per_replica,
            max_restarts=max_restarts,
        )
        return Deployment(c, name or c.__name__, config)

    return wrap(cls) if cls is not None else wrap
