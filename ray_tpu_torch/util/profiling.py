"""Profiling: the cost layer (step FLOPs and bytes, peaks, roofline).

Port of the cost-model half of `ray_tpu/util/profiling.py`: `step_cost`
counts the FLOPs and bytes of one call of a step, `device_peaks` prices
them against the card, and `roofline` turns (cost, step time) into MFU and
roofline fractions; `annotate` names a host region in `torch.profiler`
traces. The device trace, host sampling and the `ProfileStore` wait for
the control plane (ROADMAP A6).

JAX reads `compiled.cost_analysis()`, XLA's count of the compiled program;
PyTorch has no compiled program to ask. `step_cost` therefore runs the
step once on meta tensors (shapes, no data, no device work) under a
`TorchDispatchMode` that counts each aten op:
- FLOPs by `torch.utils.flop_counter`'s formulas (the matrix products);
- bytes as the op's tensor inputs read plus its outputs written once
  (views and uninitialised allocations move nothing), the sum XLA's
  "bytes accessed" makes per op;
- the hand-written kernels are custom ops (`ops/attention.py`): on meta
  tensors their fakes run, and their flop formulas count their products.
The run works on meta copies of the arguments, so the live state (which
the port's step updates in place) is not touched. Elementwise arithmetic
has no flop formula and adds bytes only: the FLOPs are the products'.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core.exceptions import ProfilingError
from .tree import flatten, rebuild

# ----------------------------------------------------------- annotations


def annotate(name: str, **kwargs: Any):
    """Named host-side region that shows up in torch.profiler traces (the
    counterpart of jax.profiler.TraceAnnotation); keyword metadata rides
    as the region's args string."""
    args = ",".join(f"{k}={v}" for k, v in sorted(kwargs.items())) or None
    return record_function(name, args)


# ----------------------------------------------------- cost model / roofline

# Published peaks (NVIDIA's data sheet, H100 SXM, dense, no sparsity):
# bf16 tensor-core FLOP/s and HBM3 bandwidth. Not measured; the same
# numbers chip_smoke.py prices its kernel bounds with.
_PEAK_FLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
}
_PEAK_HBM_BPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
# Unknown devices (and the CPU) get nominal peaks so the fractions stay
# defined; `estimated` flags them as not a hardware claim.
_FALLBACK_PEAK_FLOPS = 1e12
_FALLBACK_HBM_BPS = 100e9


def device_peaks(device: Any = None) -> Dict[str, Any]:
    """Peak FLOPs/s and HBM bandwidth of the given device (default: the
    current CUDA device when there is one). `estimated=True` marks the
    fallback used for unknown kinds and the CPU."""
    kind = "unknown"
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None
    )
    if dev is not None and dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
    elif dev is not None and dev.type == "cpu":
        kind = "cpu"
    known = kind in _PEAK_FLOPS
    return {
        "device_kind": kind,
        "peak_flops": _PEAK_FLOPS.get(kind, _FALLBACK_PEAK_FLOPS),
        "peak_hbm_bps": _PEAK_HBM_BPS.get(kind, _FALLBACK_HBM_BPS),
        "estimated": not known,
    }


@dataclasses.dataclass
class StepCost:
    """The counted cost of one call of a step, normalized as JAX's
    `cost_analysis()` one. `flops` / `bytes_accessed` are per device per
    call (one device here); `buckets` holds each op's FLOPs and bytes
    under "flops <op>" / "bytes <op>" (a kernel under its custom op's
    name, "ray_tpu_torch.flash_attention_fwd")."""

    flops: float
    bytes_accessed: float
    buckets: Dict[str, float]
    device_kind: str
    n_devices: int
    peak_flops: float           # per device
    peak_hbm_bps: float         # per device
    estimated_peaks: bool

    @property
    def total_flops(self) -> float:
        return self.flops * self.n_devices

    @property
    def total_bytes(self) -> float:
        return self.bytes_accessed * self.n_devices

    def top_buckets(self, k: int = 5) -> List[Tuple[str, float]]:
        ranked = sorted(self.buckets.items(), key=lambda kv: -abs(kv[1]))
        return ranked[:k]


# allocations that write nothing, and a reshape of a fresh tensor: no bytes move
_NO_TRAFFIC = frozenset(
    getattr(torch.ops.aten, name)
    for name in ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                 "_unsafe_view")
)


def _nbytes(values) -> int:
    leaves, _ = tree_flatten(values)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


class _CostCount(TorchDispatchMode):
    """Counts FLOPs (flop_counter's formulas) and bytes (tensor inputs read
    + outputs written) of every op dispatched inside it: aten's and the
    kernels' custom ops."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.buckets: Dict[str, float] = defaultdict(float)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.buckets[f"flops {name}"] += flops
        if nbytes:
            self.buckets[f"bytes {name}"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula is not None else 0.0
        nbytes = 0
        if not func.is_view and packet not in _NO_TRAFFIC:
            schema = func._schema
            # reads: every tensor argument; writes: the arguments the op
            # mutates (in place, or out=) and the fresh outputs it returns
            nbytes = _nbytes((args, kwargs))
            named = dict(zip((a.name for a in schema.arguments), args))
            named.update(kwargs)
            for arg in schema.arguments:
                if arg.alias_info is not None and arg.alias_info.is_write:
                    nbytes += _nbytes(named.get(arg.name))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for ret, value in zip(schema.returns, outs):
                if ret.alias_info is None:
                    nbytes += _nbytes(value)
        self.add(str(packet).replace("aten.", ""), flops, nbytes)
        return out


def _meta_leaf(_path: str, leaf: Any) -> Any:
    """A meta tensor of the leaf's shape and dtype (a leaf that requires
    grad keeps requiring it); other values are kept."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    return out.requires_grad_(True) if leaf.requires_grad and leaf.is_leaf else out


def step_cost(fn: Callable, *args: Any, **kwargs: Any) -> StepCost:
    """FLOPs/bytes of one call of `fn(*args, **kwargs)`, counted on meta
    copies of the arguments (so `fn` must run on meta tensors: build a
    step with device="meta"), priced against the device the arguments'
    tensors live on. One eager run of the step on the host: callers cache
    the result."""
    device = next((leaf.device for _, leaf in flatten((args, kwargs))
                   if isinstance(leaf, torch.Tensor)), None)
    meta_args, meta_kwargs = rebuild((args, kwargs), _meta_leaf)
    count = _CostCount()
    try:
        with count:
            fn(*meta_args, **meta_kwargs)
    except Exception as exc:  # noqa: BLE001 - typed boundary
        raise ProfilingError(f"counting the step failed: {exc!r}") from exc
    if count.flops <= 0 and count.bytes <= 0:
        raise ProfilingError("the count found no flops/bytes in this step")
    peaks = device_peaks(device)
    return StepCost(
        flops=count.flops,
        bytes_accessed=count.bytes,
        buckets=dict(count.buckets),
        device_kind=peaks["device_kind"],
        n_devices=1,
        peak_flops=peaks["peak_flops"],
        peak_hbm_bps=peaks["peak_hbm_bps"],
        estimated_peaks=peaks["estimated"],
    )


def roofline(cost: StepCost, step_time_s: float) -> Dict[str, Any]:
    """Price one step against the roofline. `mfu` is the model-FLOPs
    utilization (achieved / peak matmul throughput), `hbm_fraction` the
    share of peak HBM bandwidth the step's byte traffic implies; whichever
    fraction is higher names the binding resource. Per-device cost over
    per-device peak: the step time is wall time."""
    if step_time_s <= 0:
        raise ProfilingError(f"step_time_s must be positive, got {step_time_s}")
    mfu = cost.flops / (step_time_s * cost.peak_flops)
    hbm = cost.bytes_accessed / (step_time_s * cost.peak_hbm_bps)
    return {
        "mfu": mfu,
        "hbm_fraction": hbm,
        "bound": "memory" if hbm > mfu else "compute",
        "flops_per_device": cost.flops,
        "total_flops": cost.total_flops,
        "bytes_per_device": cost.bytes_accessed,
        "step_time_s": step_time_s,
        "n_devices": cost.n_devices,
        "device_kind": cost.device_kind,
        "estimated_peaks": cost.estimated_peaks,
    }
