"""Collectives over the process groups of a mesh axis.

Port of `ray_tpu/parallel/collectives.py`. JAX compiles a collective into
the step over a mesh axis; here a collective is a `torch.distributed`
call on the process group of that axis (`Mesh.group(axis)`), made by the
rank's own process. Three layers:

1. `Wire`: the transport of one group. It runs the few collectives the
   port uses (all-reduce, all-to-all of rows, all-gather, the tiled
   all-gather, reduce-scatter and all-to-all along dimensions, the
   neighbour shift, broadcast, barrier) on the tensors as they are, CUDA
   tensors included: NCCL takes them, and so does gloo (every collective
   here, on torch 2.11 with CUDA 12.8, probed on an H100 by
   `torch_dist_probe.py`; gloo stages them through host memory itself).
   gloo's point-to-point calls do not take CUDA tensors (a send of one
   aborts the process: "writev ... Bad address"), so the shift is an
   all-to-all with split sizes, which gloo does take, on every backend.
   It counts, per label, the bytes each rank ships under the ring model
   that `dp_sync_bytes` uses, and times labelled regions (CUDA events on
   the card, the host clock on the CPU). `shift` and `all_to_all` are
   the differentiable forms (the shift's gradient is the reverse shift,
   as `lax.ppermute` transposes; the all-to-all's is the all-to-all with
   its two dimensions swapped).
2. The int8 block-quantized reduce-scatter and all-reduce with their
   residuals (`quantized_psum_scatter_rows`, `quantized_psum_rows`), on
   a process group where JAX's take an axis name. Quantize and
   dequantize are plain tensor ops, as they are plain `jnp` in JAX, in
   JAX's order (f32 amax / 127, scale 1 for a zero block, round half to
   even, clip to ±127), and a dequantize followed by an add is one
   rounding, as XLA's fused multiply-add makes it: on the CPU the int8
   values, the residuals and the reduced rows equal JAX's bitwise.
3. The eager `CollectiveGroup` and the group manager with the
   module-level calls (reference parity: `ray.util.collective`). A rank
   passes its own tensor where JAX passes a global array: `allgather`
   stacks the ranks' tensors on a new leading axis, `reducescatter`
   returns this rank's block of the sum along the leading axis.

JAX's `all_to_all(tiled=True)` of an (n, k) rows matrix is
`all_to_all_single` on it (row r goes to rank r); its `all_gather(tiled=
False)` of a (k,) row gives (n, k). A reduce-scatter is an all-to-all of
rows followed by a local sum, as JAX's quantized one is.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class Wire:
    """The transport of one process group (`group=None` is the default
    group; `size=1`, or a one-rank group, makes every call the identity).
    On meta tensors (the cost count of `util/profiling`) a call makes
    the result's shape and moves and counts nothing.

    `stats()` gives, per label, the calls, the bytes this rank shipped
    (ring model: an all-reduce ships 2 (n-1)/n of its payload, an
    all-to-all and a reduce-scatter (n-1)/n, an all-gather n-1 times its
    input) and the seconds of the regions opened with `region(label)`.
    Collectives outside a region count under "other"."""

    def __init__(self, group: Any = None, *, size: Optional[int] = None):
        self.group = group
        self.size = size if size is not None else dist.get_world_size(group)
        self.rank = dist.get_rank(group) if self.size > 1 else 0
        self._label = "other"
        self._calls: Dict[str, int] = defaultdict(int)
        self._bytes: Dict[str, int] = defaultdict(int)
        self._cpu_s: Dict[str, float] = defaultdict(float)
        self._events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = defaultdict(list)

    @classmethod
    def for_axis(cls, mesh: Mesh, axis: str) -> "Wire":
        size = mesh.shape[axis]
        return cls(mesh.group(axis) if size > 1 else None, size=size)

    # -------------------------------------------------------------- accounting

    def _count(self, nbytes: float) -> None:
        self._calls[self._label] += 1
        self._bytes[self._label] += int(nbytes)

    @contextlib.contextmanager
    def region(self, label: str, device: Optional[torch.device] = None) -> Iterator[None]:
        """Count the collectives inside under `label` and time the region:
        on a CUDA device with events on the current stream (read by
        `stats()`, so nothing waits here), else with the host clock."""
        outer, self._label = self._label, label
        on_card = device is not None and device.type == "cuda"
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._label = outer
            if on_card:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._events[label].append((start, end))
            else:
                self._cpu_s[label] += time.perf_counter() - t0

    def stats(self) -> Dict[str, Dict[str, float]]:
        """{label: {"calls", "bytes", "seconds"}} since the last reset."""
        out: Dict[str, Dict[str, float]] = {}
        for label in set(self._calls) | set(self._cpu_s) | set(self._events):
            seconds = self._cpu_s.get(label, 0.0)
            for start, end in self._events.get(label, ()):
                end.synchronize()
                seconds += start.elapsed_time(end) / 1e3
            out[label] = {"calls": self._calls.get(label, 0), "bytes": self._bytes.get(label, 0),
                          "seconds": seconds}
        return out

    def reset(self) -> None:
        self._calls.clear()
        self._bytes.clear()
        self._cpu_s.clear()
        self._events.clear()

    # ------------------------------------------------------------- collectives

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place: x becomes the reduction over the group (on meta
        tensors nothing moves)."""
        if self.size == 1 or x.device.type == "meta":
            return x
        dist.all_reduce(x, op=getattr(dist.ReduceOp, _OPS[op]), group=self.group)
        self._count(2 * (self.size - 1) / self.size * x.numel() * x.element_size())
        return x

    def all_to_all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """x (n, ...): row r goes to rank r; out row r came from rank r."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all_rows: leading dim {x.shape[0]} != group size {self.size}")
        if self.size == 1 or x.device.type == "meta":
            return x.clone()
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        self._count((self.size - 1) / self.size * x.numel() * x.element_size())
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n, *x.shape): row r is rank r's x."""
        if self.size == 1:
            return x[None].clone()
        if x.device.type == "meta":
            return x[None].expand(self.size, *x.shape).clone()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self._count((self.size - 1) * x.numel() * x.element_size())
        return torch.stack(parts)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The members' blocks concatenated along `dim` in member order (a
        tiled all-gather, JAX's `all_gather(tiled=True)`)."""
        if self.size == 1:
            return x
        return torch.cat(list(self.all_gather(x)), dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This member's block along `dim` of the sum over the group, in
        x's dtype (a tiled reduce-scatter, JAX's `psum_scatter(tiled=
        True)`): an all-to-all of the blocks, then a local sum in member
        order."""
        if self.size == 1:
            return x
        if x.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[dim]} not divisible "
                             f"by the group size {self.size}")
        rows = x.movedim(dim, 0)
        rows = rows.reshape(self.size, rows.shape[0] // self.size, *rows.shape[1:])
        return self.all_to_all_rows(rows).sum(dim=0).movedim(0, dim)

    def shift(self, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """The neighbour shift (JAX's `ppermute` with the permutation
        i -> (i + offset) mod n): this member's x goes to member
        (r + offset) mod n, and the result is member (r - offset) mod n's
        x. An all-to-all whose only nonzero split is the neighbour's."""
        if self.size == 1 or offset % self.size == 0:
            return x.clone()
        if x.device.type == "meta":
            return torch.empty_like(x)
        flat = x.contiguous().view(-1)
        out = torch.empty_like(flat)
        n = flat.numel()
        dst, src = (self.rank + offset) % self.size, (self.rank - offset) % self.size
        dist.all_to_all_single(out, flat, output_split_sizes=[n if i == src else 0
                                                              for i in range(self.size)],
                               input_split_sizes=[n if i == dst else 0 for i in range(self.size)],
                               group=self.group)
        self._count(n * x.element_size())
        return out.view(x.shape)

    def all_to_all_dims(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """JAX's tiled `all_to_all(x, split_axis, concat_axis, tiled=True)`:
        x's `split_dim` cut into n blocks, block j sent to member j, and
        the blocks received concatenated along `concat_dim` in member
        order."""
        n = self.size
        if n == 1:
            return x.clone()
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of size {x.shape[split_dim]} not "
                             f"divisible by the group size {n}")
        rows = torch.stack(torch.chunk(x, n, dim=split_dim))
        got = self.all_to_all_rows(rows)
        return torch.cat(list(got), dim=concat_dim)

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """In place: x becomes group member `root`'s x."""
        if self.size == 1:
            return x
        src = dist.get_global_rank(self.group, root) if self.group is not None else root
        dist.broadcast(x, src=src, group=self.group)
        self._count((self.size - 1) / self.size * x.numel() * x.element_size())
        return x

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def _wire(group: Any) -> Wire:
    return group if isinstance(group, Wire) else Wire(group)


class _Shift(torch.autograd.Function):
    """The shift with its gradient: the reverse shift (`ppermute`'s
    transpose), counted under the forward's label."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, wire: Wire, offset: int):
        ctx.wire, ctx.offset, ctx.label = wire, offset, wire._label
        return wire.shift(x, offset)

    @staticmethod
    def backward(ctx, g):
        with ctx.wire.region(ctx.label, g.device):
            return ctx.wire.shift(g, -ctx.offset), None, None


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all with its gradient: the all-to-all with the
    split and concat dimensions swapped (JAX's transpose rule), counted
    under the forward's label."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, wire: Wire, split_dim: int, concat_dim: int):
        ctx.wire, ctx.dims, ctx.label = wire, (split_dim, concat_dim), wire._label
        return wire.all_to_all_dims(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        with ctx.wire.region(ctx.label, g.device):
            return ctx.wire.all_to_all_dims(g, concat_dim, split_dim), None, None, None


def shift(x: torch.Tensor, wire: Wire, offset: int = 1) -> torch.Tensor:
    """`Wire.shift` under autograd (the counterpart of `lax.ppermute` to
    the neighbour `offset` places on)."""
    return _Shift.apply(x, wire, offset)


def all_to_all(x: torch.Tensor, wire: Wire, split_dim: int, concat_dim: int) -> torch.Tensor:
    """`Wire.all_to_all_dims` under autograd (the counterpart of
    `lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`)."""
    return _AllToAll.apply(x, wire, split_dim, concat_dim)


# --------------------------------------------- quantized (int8) collectives
#
# EQuARX-style block-quantized all-reduce (arxiv 2506.17615) for the
# data-parallel gradient sync: the wire carries int8 values plus one f32
# scale per `block` elements instead of f32 — a ~3.9x byte reduction at
# block 512 — while the reduction itself runs in f32. The operand is an
# (n, k) "rows" matrix, n the group size, row r the chunk destined to
# member r; the all-reduce is
#     quantize -> all_to_all (int8 wire) -> dequant+sum   (reduce-scatter)
#     -> requantize own row -> all_gather (int8 wire) -> dequant
# Both stages return their error so callers keep an error-feedback buffer
# (the residual re-enters next step's gradient).


def quantize_int8_block(x: torch.Tensor, block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 quantization along the last axis. Returns (values
    int8, scales f32 with last dim x.shape[-1]//block). The last axis
    must be a multiple of `block`; zero blocks get scale 1 (values 0)."""
    if x.shape[-1] % block:
        raise ValueError(f"last axis {x.shape[-1]} not divisible by block {block}")
    shaped = x.float().reshape(*x.shape[:-1], x.shape[-1] // block, block)
    amax = shaped.abs().amax(dim=-1)
    scales = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(shaped / scales[..., None]), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scales


def dequantize_int8_block(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    block = values.shape[-1] // scales.shape[-1]
    shaped = values.float().reshape(*values.shape[:-1], scales.shape[-1], block)
    return (shaped * scales[..., None]).reshape(values.shape)


def _dequantize_add(values: torch.Tensor, scales: torch.Tensor,
                    addend: torch.Tensor) -> torch.Tensor:
    """values * scales + addend, rounded once to f32: a fused multiply-add,
    which is what XLA compiles JAX's multiply-then-add of these
    expressions to. The product of an int8 and an f32 is exact in f64, so
    computing in f64 and rounding once gives the FMA's result."""
    block = values.shape[-1] // scales.shape[-1]
    shaped = values.double().reshape(*values.shape[:-1], scales.shape[-1], block)
    prod = (shaped * scales.double()[..., None]).reshape(values.shape)
    return (prod + addend.double()).float()


def _sum_rows(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The sum over the leading axis of the dequantized rows, in row order,
    each row's product added to the running sum as one FMA (XLA's fused
    reduction of JAX's `jnp.sum(dequantize(...), axis=0)`)."""
    acc = dequantize_int8_block(values[0], scales[0])
    for i in range(1, values.shape[0]):
        acc = _dequantize_add(values[i], scales[i], acc)
    return acc


def psum_scatter_rows(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Reduce-scatter of a (n, k) rows matrix in its own dtype: the summed
    row this member owns, (k,) (JAX's `psum_scatter(tiled=True)[0]`)."""
    return _wire(group).all_to_all_rows(x).sum(dim=0)


def quantized_psum_scatter_rows(x: torch.Tensor, group: Any = None, *, block: int = 512):
    """Reduce-scatter of a (n, k) rows matrix with int8 wire traffic.
    Returns (own_row (k,) f32 — the summed row this member owns — and the
    local quantization error (n, k) for error feedback). `group` is a
    process group (None: the default one) or a `Wire`."""
    wire = _wire(group)
    q, s = quantize_int8_block(x, block)
    err = _dequantize_add(-q.to(torch.int16), s, x.float())  # x - q * s, one rounding
    qx = wire.all_to_all_rows(q)
    sx = wire.all_to_all_rows(s)
    own = _sum_rows(qx, sx)
    return own, err


def quantized_psum_rows(x: torch.Tensor, group: Any = None, *, block: int = 512):
    """Full all-reduce of a (n, k) rows matrix with int8 wire traffic.
    Returns (reduced (n, k) f32 — bit-identical on every member — and the
    combined local quantization error (n, k) for error feedback: stage-1
    errors everywhere plus this member's stage-2 error on its own row)."""
    wire = _wire(group)
    own, err = quantized_psum_scatter_rows(x, wire, block=block)
    q2, s2 = quantize_int8_block(own[None], block)
    err2 = _dequantize_add(-q2[0].to(torch.int16), s2[0], own)
    qg = wire.all_gather(q2[0])
    sg = wire.all_gather(s2[0])
    reduced = dequantize_int8_block(qg, sg)
    err[wire.rank] += err2
    return reduced, err


def dp_sync_bytes(
    n_params: int,
    n_replicas: int,
    *,
    mode: str = "f32",
    shard_update: bool = False,
    block: int = 512,
    param_bytes: int = 4,
) -> int:
    """Per-replica wire bytes one data-parallel sync moves per step (ring
    collective accounting: each stage ships (n-1)/n of the payload)."""
    if n_replicas <= 1:
        return 0
    f = (n_replicas - 1) / n_replicas
    scales = 4 * -(-n_params // block)
    if mode == "int8":
        grad_stage = f * (n_params + scales)          # int8 values + f32 scales
        gather_stage = f * (n_params + scales)
    else:
        grad_stage = f * n_params * param_bytes       # reduce-scatter half
        gather_stage = f * n_params * param_bytes     # all-gather half
    if shard_update:
        # grads only reduce-scatter; the gather ships updated params f32
        return int(grad_stage + f * n_params * param_bytes)
    return int(grad_stage + gather_stage)


# ----------------------------------------------------------- eager groups


class CollectiveGroup:
    """Eager collectives over one axis of a mesh (reference parity: one
    CollectiveGroup ≈ one communicator). Membership is the ranks of this
    rank's slice along `axis`; on an axis of size 1 every call is the
    identity. Calls return new tensors; the input is left as it was."""

    def __init__(self, mesh: Mesh, axis: str = "dp", name: str = "default"):
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes {mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis
        self.name = name
        self.wire = Wire.for_axis(mesh, axis)

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if op not in ("sum", "mean", "max", "min"):
            raise KeyError(op)
        out = self.wire.all_reduce(x.clone(), "sum" if op == "mean" else op)
        return out / self.size if op == "mean" else out

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        return self.wire.broadcast(x.clone(), root)

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """Gather the members' tensors along a new leading axis of size
        `group size`."""
        return self.wire.all_gather(x)

    def reducescatter(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group, scattering the leading dim across members:
        this member's block of the sum."""
        return self.wire.reduce_scatter(x) if self.size > 1 else x.clone()

    def barrier(self) -> None:
        """Complete when every member has entered."""
        self.wire.barrier()


# -------------------------------------------------------------- group manager


class _GroupManager:
    """Named collective groups (reference: GroupManager)."""

    def __init__(self):
        self._groups: Dict[str, CollectiveGroup] = {}
        self._lock = threading.Lock()

    def create(self, mesh: Mesh, axis: str, name: str) -> CollectiveGroup:
        with self._lock:
            if name in self._groups:
                raise ValueError(f"collective group {name!r} exists")
            group = CollectiveGroup(mesh, axis, name)
            self._groups[name] = group
            return group

    def get(self, name: str) -> CollectiveGroup:
        with self._lock:
            return self._groups[name]

    def destroy(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)


_manager = _GroupManager()


def init_collective_group(mesh: Mesh, axis: str = "dp", group_name: str = "default") -> CollectiveGroup:
    """Parity with the reference's init_collective_group."""
    return _manager.create(mesh, axis, group_name)


def get_group(group_name: str = "default") -> CollectiveGroup:
    return _manager.get(group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy(group_name)


def allreduce(x: torch.Tensor, group_name: str = "default", op: str = "sum") -> torch.Tensor:
    return _manager.get(group_name).allreduce(x, op)


def broadcast(x: torch.Tensor, root: int = 0, group_name: str = "default") -> torch.Tensor:
    return _manager.get(group_name).broadcast(x, root)


def allgather(x: torch.Tensor, group_name: str = "default") -> torch.Tensor:
    return _manager.get(group_name).allgather(x)


def reducescatter(x: torch.Tensor, group_name: str = "default") -> torch.Tensor:
    return _manager.get(group_name).reducescatter(x)


def barrier(group_name: str = "default") -> None:
    _manager.get(group_name).barrier()
