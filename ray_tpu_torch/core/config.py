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

# training: data-parallel sync knobs, JAX's names and defaults. On one
# device nothing syncs: LMTrainer raises for a mode other than these
# defaults, and the quantizer block and the bandwidth estimate are read
# once the mesh spans devices (ROADMAP A7)
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

# cost accounting (util/profiling.py)
define_flag("profile_cost_accounting", True,
            "Compute MFU/roofline figures for train reports from the "
            "step's counted FLOPs and bytes (util/profiling.step_cost: "
            "one run of the step on meta tensors, cached).")


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
