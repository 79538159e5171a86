"""Transformer layer primitives: norms, rotary embeddings, gated MLP acts.

Port of `ray_tpu/ops/layers.py`. Plain PyTorch: these are elementwise
chains next to large matrix products, so no hand-written kernel is
warranted here. Computation is done in float32 and cast back, as in the
JAX reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (Llama-family). scale has shape (d,)."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(dtype)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm (GPT-2-family)."""
    dtype = x.dtype
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (GPT-2 uses the approximate form)."""
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU gate: silu(gate) * up (Llama/Mixtral MLP)."""
    return F.silu(gate) * up


def rope_frequencies(
    head_dim: int,
    max_seq: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute (cos, sin) tables of shape (max_seq, head_dim // 2)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rotary position embedding over the last dim of x (B, H, S, D).

    `positions` (B, S) selects rows of the (max_seq, D/2) tables; defaults
    to arange(S). Uses the split-half convention (matches HF Llama).
    """
    s = x.shape[2]
    if positions is None:
        cos_sel = cos[:s][None, None]  # (1, 1, S, D/2)
        sin_sel = sin[:s][None, None]
    else:
        positions = positions.long()
        cos_sel = cos[positions][:, None]  # (B, 1, S, D/2)
        sin_sel = sin[positions][:, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos_sel = cos_sel.float()
    sin_sel = sin_sel.float()
    out = torch.cat(
        [x1 * cos_sel - x2 * sin_sel, x2 * cos_sel + x1 * sin_sel], dim=-1
    )
    return out.to(x.dtype)
