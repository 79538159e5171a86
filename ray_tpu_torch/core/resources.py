"""Resource model: named float resources, with the node's CUDA devices
detected as `GPU`.

Port of `ray_tpu/core/resources.py`. The JAX package reads the TPU pod's
environment (accelerator type, visible chips, topology) and falls back to
`jax.devices()`, advertising `TPU` and a `TPU-<type>-head` resource per
slice for whole-slice gangs. The port advertises `GPU`: the count of CUDA
devices this process may use (`torch.cuda.device_count()`, which honours
`CUDA_VISIBLE_DEVICES`). A slice-head resource has no counterpart on one
host; it comes with multi-node clusters.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

_EPS = 1e-9

ResourceDict = Dict[str, float]


class ResourceSet:
    """A thread-safe bag of named float resources supporting acquire/release."""

    def __init__(self, total: ResourceDict):
        self._total = dict(total)
        self._available = dict(total)
        # Consumers poll (scheduler dispatch loop / actor placement loop)
        # rather than wait on a condition: acquisition spans *multiple*
        # candidate ResourceSets, so no single CV is a correct wake signal.
        self._lock = threading.Lock()
        # Optional callback fired after every release (outside the lock):
        # a cluster node agent hangs its admission-queue drain here, so a
        # LOCAL task or actor freeing this node's ledger also admits queued
        # remote arrivals (core/cluster.py).
        self.on_release = None
        # A closed pool admits nothing new (a released placement-group
        # bundle: running work may still release into it, but restarts and
        # new leases must not draw from capacity the ledger took back).
        self.closed = False

    @property
    def total(self) -> ResourceDict:
        return dict(self._total)

    def available(self) -> ResourceDict:
        with self._lock:
            return dict(self._available)

    def can_ever_fit(self, request: ResourceDict) -> bool:
        return all(self._total.get(k, 0.0) + _EPS >= v for k, v in request.items())

    def try_acquire(self, request: ResourceDict) -> bool:
        with self._lock:
            if self.closed:
                return False
            if all(self._available.get(k, 0.0) + _EPS >= v for k, v in request.items()):
                for k, v in request.items():
                    self._available[k] = self._available.get(k, 0.0) - v
                return True
            return False

    def release(self, request: ResourceDict) -> None:
        with self._lock:
            for k, v in request.items():
                self._available[k] = min(
                    self._total.get(k, 0.0), self._available.get(k, 0.0) + v
                )
        cb = self.on_release
        if cb is not None:
            cb()


def detect_gpu_resources() -> ResourceDict:
    """{"GPU": n} for the n CUDA devices this process may use, or {} with
    none. `torch.cuda.device_count()` honours CUDA_VISIBLE_DEVICES and does
    not create a CUDA context."""
    import torch

    if not torch.cuda.is_available():
        return {}
    n = torch.cuda.device_count()
    return {"GPU": float(n)} if n else {}


def detect_host_memory() -> float:
    """Total host memory in bytes (sysconf; 8 GiB fallback) — the
    reference sizes a node's `memory` resource from the real host too."""
    try:
        return float(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):  # pragma: no cover
        return float(8 << 30)


def default_node_resources(
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[ResourceDict] = None,
    detect_accelerators: bool = True,
) -> ResourceDict:
    out: ResourceDict = {}
    out["CPU"] = float(num_cpus if num_cpus is not None else os.cpu_count() or 1)
    if num_gpus is not None:
        out["GPU"] = float(num_gpus)
    elif detect_accelerators:
        out.update(detect_gpu_resources())
    mem = detect_host_memory()
    # 70% schedulable, like the reference's default memory headroom
    out["memory"] = float(int(mem * 0.7))
    out["object_store_memory"] = float(min(int(mem * 0.2), 8 << 30))
    if resources:
        out.update({k: float(v) for k, v in resources.items()})
    return out
