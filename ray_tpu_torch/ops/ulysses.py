"""Ulysses context parallelism: all-to-all head-scattered attention.

Port of `ray_tpu/ops/ulysses.py` (the DeepSpeed-Ulysses recipe). The
inputs arrive split along the sequence over the `sp` axis; one tiled
all-to-all (`parallel.collectives.all_to_all`, JAX's `all_to_all(tiled=
True)`) re-splits them by heads, so every rank holds the whole sequence
for H/n heads and runs ordinary flash attention on them (the forward and
backward kernels on a CUDA tensor, through `flash_attention`'s custom
op), and a second all-to-all restores the sequence split. The heads must
divide the axis (a ring has no such constraint).

What differs from JAX: q, k and v travel stacked in one all-to-all (JAX
makes three of the same bytes), and a rank passes and gets back its own
sequence block: `ulysses_attention` takes the blocks,
`ulysses_attention_sharded` the global tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.collectives import Wire, all_to_all
from ..parallel.mesh import Mesh
from .attention import flash_attention
from .ring_attention import _repeat_kv, sequence_block


def _ulysses_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, wire: Wire,
                   causal: bool, sm_scale: float,
                   implementation: Optional[str]) -> torch.Tensor:
    """The body on this rank's blocks, q / k / v (B, H, S/n, D)."""
    # scatter heads, gather sequence: (3, B, H, S/n, D) -> (3, B, H/n, S, D)
    with wire.region("sp_all_to_all", q.device):
        qkv = all_to_all(torch.stack([q, k, v]), wire, split_dim=2, concat_dim=3)
    out = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal, sm_scale=sm_scale,
                          implementation=implementation)
    # scatter sequence, gather heads: back to (B, H, S/n, D)
    with wire.region("sp_all_to_all", q.device):
        return all_to_all(out, wire, split_dim=2, concat_dim=1)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = "sp",
    causal: bool = False,
    sm_scale: Optional[float] = None,
    implementation: Optional[str] = None,
    wire: Optional[Wire] = None,
) -> torch.Tensor:
    """Sequence-parallel exact attention by head scattering on this rank's
    blocks: q (B, Hq, S/n, D), k / v (B, Hkv, S/n, D); Hq must divide by
    the axis size. Returns this rank's block of the output. Differentiable
    (the all-to-all's gradient is the all-to-all back; the flash kernels
    have theirs). `wire` (default: a new one over the axis' group)
    carries the all-to-alls and counts their bytes."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _repeat_kv(q, k, v)
    n = mesh.shape[axis]
    _check_heads(q.shape[1], n, axis)
    wire = wire if wire is not None else Wire.for_axis(mesh, axis)
    return _ulysses_local(q, k, v, wire=wire, causal=causal, sm_scale=sm_scale,
                          implementation=implementation)


def _check_heads(hq: int, n: int, axis: str) -> None:
    if hq % n:
        raise ValueError(
            f"Ulysses needs heads ({hq}) divisible by the {axis} axis ({n}); "
            "use ring_attention for head counts below the axis size"
        )


def ulysses_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """The global q / k / v, every rank holding them whole: this rank's
    sequence blocks through `ulysses_attention`. Returns this rank's block
    of the output."""
    k, v = _repeat_kv(q, k, v)
    q, k, v = (sequence_block(t, mesh, axis) for t in (q, k, v))
    return ulysses_attention(q, k, v, mesh=mesh, axis=axis, causal=causal)
