"""Ring attention: exact attention over sequence blocks on a mesh axis.

Port of `ray_tpu/ops/ring_attention.py`. The sequence is split over the
`sp` axis of a mesh; each rank keeps its query block and the key / value
blocks go round the ring, one neighbour shift a step
(`parallel.collectives.Wire.shift`, JAX's `ppermute`), while the rank
accumulates the blockwise online softmax (Liu et al., Ring Attention).
Memory per rank is one (S/n x S/n) block at a time, never (S x S).

Two bodies, as in JAX:
- `_ring_attention_local`: the plain body over (m, l, acc) in f32 with
  causal block skipping (a key block wholly in this rank's future is
  skipped, the diagonal one masked). It is differentiable: its backward
  is the ring in reverse (`_ring_backward_plain`), which JAX gets by
  transposing the scan (the shift's transpose is the reverse shift).
- `_ring_fused_local`: each ring block runs through the flash forward
  kernel (`flash_attention_with_lse`: the CUDA kernel on a CUDA tensor,
  its plain version on a CPU one), the diagonal block causal, past blocks
  `causal=False`, future blocks launching nothing; blocks merge by
  logaddexp of their lse. `_RingFused` gives it the plain body's
  gradient: the backward recomputes the ring through the plain body, as
  JAX's `custom_vjp` does.

What differs from JAX, and why:
- A rank passes and gets back its own sequence block (the port's rule:
  a rank holds its block). `ring_attention` takes the blocks;
  `ring_attention_sharded` takes the global tensors and returns this
  rank's block of the output.
- The ring moves k and v stacked, one shift a step, and makes n - 1
  shifts: JAX's scan makes the n-th too and drops its result.
- The backward is written out, not left to autograd through the shifts:
  autograd runs no node whose output reaches no loss, so a rank whose
  later ring steps are all skipped (rank 0 under causal) would make fewer
  reverse shifts than its neighbours and the ring would hang. Written
  out, every rank makes the same shifts in the same order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.collectives import Wire
from ..parallel.mesh import Mesh, NamedSharding, PartitionSpec
from .attention import _NEG_INF, flash_attention_with_lse


def _block_kind(kv_idx: int, my_idx: int, causal: bool) -> str:
    """Which ring block this is for the rank: "skip" (wholly in the
    future), "diag" (causal within) or "full"."""
    if not causal or kv_idx < my_idx:
        return "full"
    return "diag" if kv_idx == my_idx else "skip"


def _block_scores(q32, k, kind: str, sm_scale: float) -> torch.Tensor:
    """(B, H, S_local, S_local) f32 scores of one ring block, the diagonal
    block's future masked to -1e30."""
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k.float()) * sm_scale
    if kind == "diag":
        rows = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(rows[None, :] <= rows[:, None], s, _NEG_INF)
    return s


@torch.no_grad()
def _ring_forward_plain(q, k, v, wire: Wire, causal: bool, sm_scale: float):
    """The plain body's forward over (m, l, acc) in f32: (out f32, lse)."""
    n, my_idx = wire.size, wire.rank
    b, h, s_local, d = q.shape
    q32 = q.float()
    m = torch.full((b, h, s_local, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_local, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        kind = _block_kind((my_idx - step) % n, my_idx, causal)
        if kind != "skip":
            s = _block_scores(q32, kv[0], kind, sm_scale)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, kv[1].float())
            m = m_new
        if step < n - 1:
            with wire.region("sp_shift", q.device):
                kv = wire.shift(kv)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l == 0.0, torch.full_like(l, _NEG_INF), m + torch.log(safe_l))
    return acc / safe_l, lse


@torch.no_grad()
def _ring_backward_plain(q, k, v, out, lse, do, wire: Wire, causal: bool, sm_scale: float):
    """The plain body's backward, the ring written out in reverse (JAX gets
    it by transposing the scan): each rank keeps dq for its queries, and
    the dk / dv of the visiting key block travel with it, one shift a
    step, arriving home after n shifts. P is recomputed from the lse.
    Every rank makes the same shifts, skipped blocks included."""
    n, my_idx = wire.size, wire.rank
    q32, do32 = q.float(), do.float()
    delta = (do32 * out).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(q32)
    kv = torch.stack([k, v])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    for step in range(n):
        kind = _block_kind((my_idx - step) % n, my_idx, causal)
        if kind != "skip":
            k32, v32 = kv[0].float(), kv[1].float()
            p = torch.exp(_block_scores(q32, kv[0], kind, sm_scale) - lse)
            dkv[1] += torch.einsum("bhqk,bhqd->bhkd", p, do32)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", do32, v32) - delta) * sm_scale
            dq += torch.einsum("bhqk,bhkd->bhqd", ds, k32)
            dkv[0] += torch.einsum("bhqk,bhqd->bhkd", ds, q32)
        with wire.region("sp_shift", q.device):
            if step < n - 1:
                kv = wire.shift(kv)
            dkv = wire.shift(dkv)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingPlain(torch.autograd.Function):
    """The plain body with its ring backward."""

    @staticmethod
    def forward(ctx, q, k, v, wire: Wire, causal: bool, sm_scale: float):
        out, lse = _ring_forward_plain(q, k, v, wire, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (wire, causal, sm_scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        grads = _ring_backward_plain(*ctx.saved_tensors, do, *ctx.args)
        return (*grads, None, None, None)


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, wire: Wire,
                          causal: bool, sm_scale: float) -> torch.Tensor:
    """The plain body on this rank's blocks, q / k / v (B, H, S_local, D):
    differentiable, its backward the ring in reverse."""
    return _RingPlain.apply(q, k, v, wire, causal, sm_scale)


@torch.no_grad()
def _ring_fused_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, wire: Wire,
                      causal: bool, sm_scale: float,
                      block_impl: Optional[str] = None) -> torch.Tensor:
    """The fused body: each ring block through the flash forward kernel,
    blocks merged by their lse (no gradient: `_RingFused` gives it one)."""
    n, my_idx = wire.size, wire.rank
    b, h, s_local, d = q.shape
    o_acc = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, h, s_local, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        kind = _block_kind((my_idx - step) % n, my_idx, causal)
        if kind != "skip":
            o, lse = flash_attention_with_lse(q, kv[0], kv[1], causal=kind == "diag",
                                              sm_scale=sm_scale, implementation=block_impl)
            new = torch.logaddexp(lse_acc, lse)
            o_acc = o_acc * torch.exp(lse_acc - new) + o.float() * torch.exp(lse - new)
            lse_acc = new
        if step < n - 1:
            with wire.region("sp_shift", q.device):
                kv = wire.shift(kv)
    return o_acc.to(q.dtype)


class _RingFused(torch.autograd.Function):
    """The fused forward with the plain body's backward: the flash
    kernel's gradient does not thread through the lse merge across ring
    steps, so the backward recomputes the ring's forward through the plain
    body and runs its backward, as JAX's `custom_vjp` does."""

    @staticmethod
    def forward(ctx, q, k, v, wire: Wire, causal: bool, sm_scale: float,
                block_impl: Optional[str]):
        ctx.save_for_backward(q, k, v)
        ctx.args = (wire, causal, sm_scale)
        return _ring_fused_local(q, k, v, wire=wire, causal=causal, sm_scale=sm_scale,
                                 block_impl=block_impl)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        out, lse = _ring_forward_plain(q, k, v, *ctx.args)
        grads = _ring_backward_plain(q, k, v, out, lse, do, *ctx.args)
        return (*grads, None, None, None, None)


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """GQA: each kv head repeated over its group of query heads, as JAX's
    `jnp.repeat(k, groups, axis=1)`."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq == hkv:
        return k, v
    groups = hq // hkv
    return k.repeat_interleave(groups, dim=1), v.repeat_interleave(groups, dim=1)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = "sp",
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "fused",
    block_impl: Optional[str] = None,
    wire: Optional[Wire] = None,
) -> torch.Tensor:
    """Sequence-parallel exact attention on this rank's blocks: q
    (B, Hq, S/n, D), k / v (B, Hkv, S/n, D), the rank's block of a
    sequence split over `axis` in rank order. Returns this rank's block
    of the output, (B, Hq, S/n, D).

    impl: "fused" (each ring block through the flash forward kernel; the
    backward through the plain body) or "einsum" (the plain body, forward
    and backward). `block_impl` is the flash implementation each fused
    block runs (`flash_attention_with_lse`'s `implementation`). `wire`
    (default: a new one over the axis' group) carries the shifts and
    counts their bytes."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _repeat_kv(q, k, v)
    wire = wire if wire is not None else Wire.for_axis(mesh, axis)
    if impl == "fused":
        return _RingFused.apply(q, k, v, wire, causal, sm_scale, block_impl)
    if impl == "einsum":
        return _ring_attention_local(q, k, v, wire=wire, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"unknown ring impl {impl!r}")


def sequence_block(x: torch.Tensor, mesh: Mesh, axis: str = "sp") -> torch.Tensor:
    """This rank's block of a (B, H, S, D) tensor split over `axis` along
    the sequence (JAX's placement by `P(None, None, axis, None)`)."""
    n = mesh.shape[axis]
    if x.shape[2] % n:
        raise ValueError(f"seq {x.shape[2]} not divisible by {axis}={n}")
    return NamedSharding(mesh, PartitionSpec(None, None, axis, None)).shard(x)


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """The global q / k / v, every rank holding them whole: this rank's
    sequence blocks through `ring_attention`. Returns this rank's block of
    the output (JAX's result stays sharded the same way)."""
    k, v = _repeat_kv(q, k, v)
    q, k, v = (sequence_block(t, mesh, axis) for t in (q, k, v))
    return ring_attention(q, k, v, mesh=mesh, axis=axis, causal=causal)
