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
  The exception is the single-controller form, one program over local
  tp shards, which serving uses (`LLMServer(tensor_parallel=n)`):
  `build_mesh(MeshSpec(tp=n), devices=[d] * n)` outside a
  `torch.distributed` job holds all n devices and no process group. A
  device may repeat (the shards then share it: `["cpu"] * n` in the CPU
  tests, `["cuda:0"] * n` on one card); n distinct CUDA devices raise
  NotImplementedError naming ROADMAP A4 (TP serving across cards).
  Training refuses such a mesh (`Mesh.device`, `ModelSharding`).
- Every axis lays out over a torch.distributed job, as in JAX. JAX
  shards parameters over fsdp, tp and ep through GSPMD's partitioner,
  which PyTorch has no counterpart for: the port writes those collectives
  out (`parallel/spmd.py`: ZeRO-3 gathers over fsdp, Megatron's column-
  and row-parallel products over tp, the experts' enter / leave pair over
  ep), so JAX's default for n devices, `MeshSpec().with_devices(n)`
  (fsdp=n), is a mesh the port trains on. Over sp the attention ops
  rotate or scatter the sequence blocks themselves (`ops/ring_attention`,
  `ops/ulysses`), and over pp the schedule is written out
  (`parallel/pipeline.py`), as JAX's shard_map bodies do.
- `NamedSharding.assemble` is the inverse of `shard`: the global array
  from every rank's block, which JAX's `np.asarray` of a sharded array
  gives (the port's ranks hold blocks only).
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

import numpy as np
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

ACROSS_CARDS_ITEM = "ROADMAP A4 (TP serving across cards)"


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
    of size > 1 (the ranks that differ from this one on that axis only).

    A single-controller mesh (`local`) holds every device of its spec in
    row-major order (`devices[i]` at `coords_of(spec, i)`), rank 0 and no
    group: one process runs the program of every shard."""

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
    def local(self) -> bool:
        """Whether this process runs every device of the mesh (the
        single-controller form) rather than one rank's."""
        return len(self.devices) > 1

    @property
    def device(self) -> torch.device:
        """This rank's device. A single-controller mesh has no one device
        and raises: training runs one rank per process."""
        if self.local:
            raise ValueError(
                f"this mesh holds {len(self.devices)} local devices (one program over its "
                f"tp shards, for serving); training runs one rank per process: build its "
                f"mesh inside a torch.distributed job"
            )
        return self.devices[0]

    def device_coords(self, index: int) -> Dict[str, int]:
        """The coordinates of `devices[index]` on each axis."""
        return dict(zip(AXIS_ORDER, coords_of(self.spec, index)))

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
    (default "cuda": the current CUDA device, raising without one), or,
    for a single-controller tp mesh, all of its devices (`_local_mesh`).

    A spec over one device needs no process group. A spec over n > 1
    devices needs a `torch.distributed` job of world size n, initialised
    by the caller (`init_process_group`, as the multihost gang's ranks
    are); `backend` builds the axis groups on another backend than the
    job's default one."""
    devices = list(devices) if devices is not None else ["cuda"]
    if len(devices) > 1:
        return _local_mesh(spec, devices)
    if not devices:
        raise ValueError("a mesh needs a device")
    dev = _resolve(devices[0])
    if spec.num_devices == 1:
        return Mesh(spec, (dev,))
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


def _resolve(device: Union[str, torch.device]) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _local_mesh(spec: MeshSpec, devices: Sequence[Union[str, torch.device]]) -> Mesh:
    """The single-controller form: every device of a tp-only spec in this
    process, which must not be a rank of a torch.distributed job. The
    devices are of one type; they may repeat (shards that share a device),
    and n distinct CUDA devices raise NotImplementedError: a program over
    several cards needs peer copies or NCCL inside the serving graphs,
    which no machine here can check."""
    if len(devices) != spec.num_devices:
        raise ValueError(
            f"MeshSpec {spec.describe()} wants {spec.num_devices} devices, got {len(devices)}"
        )
    others = [a for a in AXIS_ORDER if a != "tp" and getattr(spec, a) > 1]
    if others:
        raise ValueError(
            f"MeshSpec {spec.describe()}: a mesh over this process's devices splits tp only "
            f"(one serving program over its shards); {others} need a torch.distributed job "
            f"with one rank per device"
        )
    if dist.is_available() and dist.is_initialized():
        raise ValueError(
            "a mesh over several devices is one program's; this process is a rank of a "
            "torch.distributed job, whose mesh holds the rank's own device"
        )
    devs = tuple(_resolve(d) for d in devices)
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices are of one type, got {[str(d) for d in devs]}")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"a mesh over distinct devices {sorted({str(d) for d in devs})}: the port runs "
            f"the tp shards of one program on one device until {ACROSS_CARDS_ITEM}"
        )
    return Mesh(spec, devs)


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


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_parts(shape: Dict[str, int], coords: Dict[str, int], spec: Sequence,
                dim: int) -> Tuple[int, int]:
    """(number of blocks, the block at `coords`) along dimension `dim` of
    an array laid out by `spec` over a mesh of axis sizes `shape`: the
    row-major index of the coordinates on the entry's axes."""
    if dim >= len(spec):
        return 1, 0
    count, index = 1, 0
    for axis in spec_axes(spec[dim]):
        count, index = count * shape[axis], index * shape[axis] + coords[axis]
    return count, index


@dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec over a mesh (JAX's `NamedSharding`). `shard(x)`
    takes this rank's block of a global array: each dimension named by
    axes is split into as many equal blocks as those axes' sizes
    multiply to, and the rank keeps the block at its row-major
    coordinate on them (JAX's placement of a global array).
    `assemble(blocks)` puts every rank's block back in its place."""

    mesh: Mesh
    spec: PartitionSpec

    def parts(self, dim: int) -> Tuple[int, int]:
        """(number of blocks, this rank's block) along dimension `dim`."""
        return block_parts(self.mesh.shape, self.mesh.coords, self.spec, dim)

    def local_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for dim, size in enumerate(global_shape):
            count, _ = self.parts(dim)
            if size % count:
                raise ValueError(f"dim {dim} of size {size} not divisible into {count} blocks "
                                 f"({self.spec})")
            out.append(size // count)
        return tuple(out)

    def block(self, x, coords: Dict[str, int]):
        """The block of the global array `x` at mesh coordinates `coords`
        (a view): `shard` at any device of the mesh, such as each shard of
        a single-controller mesh (`Mesh.device_coords`)."""
        return x[self._index(coords, self.local_shape(x.shape))]

    def _index(self, coords: Dict[str, int], local: Sequence[int]) -> Tuple[slice, ...]:
        index = []
        for dim, size in enumerate(local):
            _, i = block_parts(self.mesh.shape, coords, self.spec, dim)
            index.append(slice(i * size, (i + 1) * size))
        return tuple(index)

    def shard(self, x):
        """This rank's block of the global array `x` (a numpy array or a
        tensor): a view, not a copy."""
        return self.block(x, self.mesh.coords)

    def assemble(self, blocks: Sequence):
        """The global array from every rank's block, `blocks[r]` being
        world rank r's (numpy arrays or tensors, one kind): each block
        goes where `shard` took it from; a block that several ranks hold
        is taken from the first of them."""
        first = blocks[0]
        if len(blocks) != self.mesh.size:
            raise ValueError(f"assemble: {len(blocks)} blocks for a mesh of {self.mesh.size} ranks")
        global_shape = []
        for dim, size in enumerate(first.shape):
            global_shape.append(size * self.parts(dim)[0])
        if isinstance(first, torch.Tensor):
            out = first.new_empty(global_shape)
        else:
            out = np.empty(global_shape, dtype=first.dtype)
        done = set()
        for rank, block in enumerate(blocks):
            index = self._index(dict(zip(AXIS_ORDER, coords_of(self.mesh.spec, rank))), block.shape)
            key = tuple((s.start, s.stop) for s in index)
            if key not in done:
                out[index] = block
                done.add(key)
        return out


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
