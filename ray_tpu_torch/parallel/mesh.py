"""Device-mesh vocabulary over the ranks of a `torch.distributed` job.

Port of `ray_tpu/parallel/mesh.py`. `MeshSpec` keeps JAX's six named axes
(dp/pp/fsdp/ep/sp/tp), their order and `with_devices` / `describe`.
`build_mesh` lays the spec's axes out row-major over the world's ranks
(rank = the row-major index of its coordinates, as JAX's device array is
laid out) and builds one process group per axis slice; `Mesh` is that
layout seen from this process: its rank, coordinates, device and the
group of each axis it belongs to.

What differs from JAX, and why:
- One process per rank, one device per process: `Mesh.devices` holds
  this process's device (JAX's mesh holds every device of the job).
- Pure data parallelism only. A spec with fsdp, tp, sp, ep or pp above 1
  raises NotImplementedError: those axes shard parameters through
  GSPMD's partitioner, which PyTorch has no counterpart for; they come
  with ROADMAP A4's FSDP/TP training through the sharding rules. JAX's
  default for n devices, `MeshSpec().with_devices(n)`, is fsdp=n, so a
  bare `LMTrainer` in a gang of n > 1 raises the same error and never
  silently becomes dp.
- The backend is fixed when the job calls `init_process_group` (NCCL
  when every rank has its own device, gloo otherwise: NCCL refuses two
  ranks on one device), or named by `build_mesh(backend=)`, which builds
  the axis groups on it. Nothing switches backend after a failure.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .._device import resolve_device

# Canonical axis order, outermost (slowest) to innermost (fastest link):
# data-parallel axes outermost — their gradient all-reduce is the least
# latency-sensitive — and tensor-parallel innermost, on the matmuls'
# critical path.
AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "fsdp", "ep", "sp", "tp")

# Axes over which batch (data) is partitioned.
DATA_AXES: Tuple[str, ...] = ("dp", "fsdp")

# the axes that shard parameters or activations: GSPMD-style sharding
SHARDING_AXES: Tuple[str, ...] = ("pp", "fsdp", "ep", "sp", "tp")
SHARDING_ITEM = "ROADMAP A4 (FSDP/TP training through the sharding rules)"


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


def coords_of(spec: MeshSpec, rank: int) -> Tuple[int, ...]:
    """The coordinates of world rank `rank` on the spec's axes (row-major
    over AXIS_ORDER: the last axis varies fastest)."""
    out = []
    for size in reversed(spec.shape):
        out.append(rank % size)
        rank //= size
    return tuple(reversed(out))


def rank_of(spec: MeshSpec, coords: Sequence[int]) -> int:
    rank = 0
    for size, c in zip(spec.shape, coords):
        rank = rank * size + c
    return rank


@dataclass(frozen=True)
class Mesh:
    """The spec's layout over the job's ranks, seen from this process:
    `devices` holds this rank's device, `rank` its world rank, `coords`
    its coordinate on each axis, `groups` the process group of each axis
    of size > 1 (the ranks that differ from this one on that axis only)."""

    spec: MeshSpec
    devices: Tuple[torch.device, ...]
    rank: int = 0
    backend: Optional[str] = None
    groups: Dict[str, object] = field(default_factory=dict, compare=False, repr=False)

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

    @property
    def size(self) -> int:
        return self.spec.num_devices

    @property
    def coords(self) -> Dict[str, int]:
        return dict(zip(AXIS_ORDER, coords_of(self.spec, self.rank)))

    def axis_index(self, axis: str) -> int:
        """This rank's index on `axis` (JAX's `lax.axis_index`)."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's slice along `axis`; None for an
        axis of size 1 (a collective over it is the identity)."""
        if axis not in AXIS_ORDER:
            raise ValueError(f"axis {axis!r} not in mesh axes {AXIS_ORDER}")
        return self.groups.get(axis)


def _check_pure_dp(spec: MeshSpec) -> None:
    sharded = [a for a in SHARDING_AXES if getattr(spec, a) > 1]
    if sharded:
        raise NotImplementedError(
            f"MeshSpec {spec.describe()}: the axes {sharded} shard parameters or "
            f"activations through GSPMD-style partitioning, which the port does "
            f"not have yet; it builds pure data-parallel meshes (dp only) until "
            f"{SHARDING_ITEM}"
        )


def _axis_groups(spec: MeshSpec, rank: int, backend: Optional[str]) -> Dict[str, object]:
    """One process group per slice of every axis of size > 1, created on
    every rank in the same order (`new_group` is collective); returns the
    groups this rank belongs to."""
    mine: Dict[str, object] = {}
    for i, axis in enumerate(AXIS_ORDER):
        if spec.shape[i] == 1:
            continue
        others = [range(s) if j != i else range(1) for j, s in enumerate(spec.shape)]
        for base in itertools.product(*others):
            ranks = []
            for c in range(spec.shape[i]):
                coords = list(base)
                coords[i] = c
                ranks.append(rank_of(spec, coords))
            group = dist.new_group(ranks=ranks, backend=backend)
            if rank in ranks:
                mine[axis] = group
    return mine


def build_mesh(
    spec: MeshSpec,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    *,
    backend: Optional[str] = None,
) -> Mesh:
    """A `Mesh` matching the spec. `devices` names this process's device
    (default "cuda": the current CUDA device, raising without one).

    A spec over one device needs no process group. A spec over n > 1
    devices needs a `torch.distributed` job of world size n, initialised
    by the caller (`init_process_group`, as the multihost gang's ranks
    are); `backend` builds the axis groups on another backend than the
    job's default one. Specs past pure dp raise NotImplementedError."""
    devices = list(devices) if devices is not None else ["cuda"]
    if len(devices) != 1:
        raise ValueError(f"a mesh holds this process's device: got {len(devices)} devices")
    dev = resolve_device(devices[0])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if spec.num_devices == 1:
        return Mesh(spec, (dev,))
    _check_pure_dp(spec)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"MeshSpec {spec.describe()} wants {spec.num_devices} ranks; this process "
            f"is not in a torch.distributed job (init_process_group, or a "
            f"MultihostWorkerGroup rank)"
        )
    world = dist.get_world_size()
    if world != spec.num_devices:
        raise ValueError(
            f"MeshSpec {spec.describe()} wants {spec.num_devices} ranks, the job has {world}"
        )
    rank = dist.get_rank()
    backend = backend or dist.get_backend()
    return Mesh(spec, (dev,), rank=rank, backend=backend,
                groups=_axis_groups(spec, rank, backend))


def single_device_mesh(device: Union[str, torch.device] = "cuda") -> Mesh:
    return build_mesh(MeshSpec(), [device])


# ------------------------------------------------------------------ shardings


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array (JAX's `PartitionSpec`): each
    entry is None (not split), an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec over a mesh (JAX's `NamedSharding`). `shard(x)`
    takes this rank's block of a global array: each dimension named by
    axes is split into as many equal blocks as those axes' sizes
    multiply to, and the rank keeps the block at its row-major
    coordinate on them (JAX's placement of a global array)."""

    mesh: Mesh
    spec: PartitionSpec

    def _axes(self, entry) -> Tuple[str, ...]:
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def parts(self, dim: int) -> Tuple[int, int]:
        """(number of blocks, this rank's block) along dimension `dim`."""
        if dim >= len(self.spec):
            return 1, 0
        count, index = 1, 0
        for axis in self._axes(self.spec[dim]):
            size = self.mesh.shape[axis]
            count, index = count * size, index * size + self.mesh.axis_index(axis)
        return count, index

    def local_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for dim, size in enumerate(global_shape):
            count, _ = self.parts(dim)
            if size % count:
                raise ValueError(f"dim {dim} of size {size} not divisible into {count} blocks "
                                 f"({self.spec})")
            out.append(size // count)
        return tuple(out)

    def shard(self, x):
        """This rank's block of the global array `x` (a numpy array or a
        tensor): a view, not a copy."""
        local = self.local_shape(x.shape)
        index = []
        for dim, size in enumerate(local):
            _, i = self.parts(dim)
            index.append(slice(i * size, (i + 1) * size))
        return x[tuple(index)]


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def data_sharding(mesh: Mesh, *trailing: Optional[str]) -> NamedSharding:
    """Sharding for a [batch, ...] array: batch split over dp+fsdp."""
    return NamedSharding(mesh, PartitionSpec(DATA_AXES, *trailing))


# ------------------------------------------------------------------- registry


class MeshRegistry:
    """Named meshes shared across the process (parity: GroupManager).
    Gang ranks look their mesh up by name instead of plumbing Mesh
    objects through task args."""

    def __init__(self):
        self._meshes: Dict[str, Mesh] = {}
        self._lock = threading.Lock()

    def register(self, name: str, mesh: Mesh, overwrite: bool = False) -> Mesh:
        with self._lock:
            if name in self._meshes and not overwrite:
                raise ValueError(f"mesh {name!r} already registered")
            self._meshes[name] = mesh
            return mesh

    def get(self, name: str) -> Mesh:
        with self._lock:
            if name not in self._meshes:
                raise KeyError(
                    f"mesh {name!r} not registered (have: {list(self._meshes)})"
                )
            return self._meshes[name]

    def get_or_create(self, name: str, spec: MeshSpec, **kwargs) -> Mesh:
        with self._lock:
            if name not in self._meshes:
                self._meshes[name] = build_mesh(spec, **kwargs)
            return self._meshes[name]

    def names(self) -> List[str]:
        with self._lock:
            return list(self._meshes)

    def clear(self) -> None:
        with self._lock:
            self._meshes.clear()


_registry = MeshRegistry()


def mesh_registry() -> MeshRegistry:
    return _registry
