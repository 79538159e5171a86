"""Device-mesh vocabulary over torch devices.

Port of `ray_tpu/parallel/mesh.py` for one device: `MeshSpec` keeps JAX's
six named axes (dp/pp/fsdp/ep/sp/tp), their order and `with_devices` /
`describe`, and `build_mesh` / `single_device_mesh` build a `Mesh` over
one torch device. A spec that covers more than one device raises
`NotImplementedError`: the multi-device mesh (on `torch.distributed`)
comes with ROADMAP A7, with the sharding rules and collectives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from .._device import resolve_device

# Canonical axis order, outermost (slowest) to innermost (fastest link):
# data-parallel axes outermost — their gradient all-reduce is the least
# latency-sensitive — and tensor-parallel innermost, on the matmuls'
# critical path.
AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "fsdp", "ep", "sp", "tp")

# Axes over which batch (data) is partitioned.
DATA_AXES: Tuple[str, ...] = ("dp", "fsdp")


@dataclass(frozen=True)
class MeshSpec:
    """Named-axis mesh sizes. Size 1 axes are kept in the mesh, so one
    model definition serves every config."""

    dp: int = 1     # pure data parallel (replicated params)
    pp: int = 1     # pipeline stages
    fsdp: int = 1   # sharded-data-parallel (params/opt-state sharded)
    ep: int = 1     # expert parallel (MoE)
    sp: int = 1     # sequence/context parallel (ring attention)
    tp: int = 1     # tensor parallel

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @property
    def num_devices(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    def with_devices(self, n: int, prefer: str = "fsdp") -> "MeshSpec":
        """Scale the given axis so the spec covers n devices."""
        fixed = self.num_devices // getattr(self, prefer)
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes ({fixed})")
        return MeshSpec(**{**self.__dict__, prefer: n // fixed})

    def describe(self) -> str:
        return "x".join(f"{a}={getattr(self, a)}" for a in AXIS_ORDER if getattr(self, a) > 1) or "single"


@dataclass(frozen=True)
class Mesh:
    """Devices laid out on the named axes: `devices` in row-major order
    over `shape` (one device until ROADMAP A7)."""

    spec: MeshSpec
    devices: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape` gives it."""
        return dict(zip(AXIS_ORDER, self.spec.shape))

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def build_mesh(
    spec: MeshSpec,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """A `Mesh` matching the spec over `devices` (default: one CUDA
    device, raising without one). More than one device raises
    NotImplementedError until the multi-device mesh lands (ROADMAP A7)."""
    if spec.num_devices != 1:
        raise NotImplementedError(
            f"MeshSpec {spec.describe()} spans {spec.num_devices} devices; the port "
            f"builds one-device meshes only until the multi-device mesh "
            f"(ROADMAP A7)"
        )
    devices = list(devices) if devices is not None else ["cuda"]
    if len(devices) != 1:
        raise ValueError(f"MeshSpec {spec.describe()} wants 1 device, got {len(devices)}")
    return Mesh(spec, (resolve_device(devices[0]),))


def single_device_mesh(device: Union[str, torch.device] = "cuda") -> Mesh:
    return build_mesh(MeshSpec(), [device])
