"""Flash attention forward: a CUDA kernel for Hopper + plain PyTorch paths.

Port of the forward half of `ray_tpu/ops/attention.py`. The kernel
(`csrc/flash_attention_fwd.cu`) replaces the Pallas TPU forward
(`_fwd_kernel` / `_fwd_pallas`, and the pipelined `_fwd_pipe_tpu` that
computes the same function). Its plain PyTorch version is
`_flash_fwd_plain` below.

Dispatch is by device: a CUDA tensor launches the kernel (or raises on a
shape or dtype it does not take); a CPU tensor takes the plain version.
There is no other fallback.

Layout convention: q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with
Hq % Hkv == 0 (grouped-query attention: q head h reads kv head
h // (Hq // Hkv), no materialized repeat on the kernel path).

Forward only: the backward kernels are not ported yet, so a call whose
inputs require a gradient raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._build import Kernel

_NEG_INF = -1e30  # finite "minus infinity": keeps exp() at exactly 0.0 without NaNs
_LOG2E = 1.4426950408889634  # the kernel folds log2(e) into sm_scale and uses exp2

FLASH_FWD = Kernel(
    "flash_attention_fwd",
    "flash_attention_fwd.cu",
    "flash_attention_fwd_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, hq: int):
    hkv = k.shape[1]
    if hq == hkv:
        return k, v
    groups = hq // hkv
    return (
        torch.repeat_interleave(k, groups, dim=1),
        torch.repeat_interleave(v, groups, dim=1),
    )


def _no_grad_check(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "flash attention is forward-only in ray_tpu_torch: the backward "
            "kernels (ray_tpu/ops/attention.py _dkv_kernel/_dq_kernel) are not "
            "ported yet; call under torch.no_grad()"
        )


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain multi-head attention: the semantic ground truth. Supports GQA
    and right-padding via `kv_len`."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    k, v = _repeat_kv(k, v, q.shape[1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    cols = torch.arange(skv, device=q.device)
    mask = None
    if kv_len is not None:
        mask = cols[None, :] < kv_len
    if causal:
        rows = torch.arange(sq, device=q.device)
        causal_mask = cols[None, :] <= rows[:, None] + (skv - sq)
        mask = causal_mask if mask is None else (mask & causal_mask)
    if mask is not None:
        logits = torch.where(mask[None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _flash_fwd_plain(q, k, v, causal: bool, sm_scale: float):
    """The kernel's function in plain PyTorch: f32 scores, p rounded to
    v's dtype before P.V, natural-log lse, fully masked rows at lse -1e30
    with O = 0."""
    sq, skv = q.shape[2], k.shape[2]
    k, v = _repeat_kv(k, v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / safe_l
    lse = torch.where(l == 0.0, torch.full_like(l, _NEG_INF), m + torch.log(safe_l))
    return out.to(q.dtype), lse


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch the CUDA forward kernel; returns (out, lse (B, Hq, Sq, 1))."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernel: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash kernel: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {_KERNEL_HEAD_DIMS}, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq, 1), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODES[q.dtype], d, b, hq, hkv, sq, skv, int(causal),
        float(sm_scale * _LOG2E), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row logsumexp of the
    scaled scores, shape (B, Hq, Sq, 1) float32 (natural log)."""
    _no_grad_check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if causal and q.shape[2] != k.shape[2]:
        raise NotImplementedError("causal flash kernel requires Sq == Skv")
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, sm_scale)
    return _flash_fwd_plain(q, k, v, causal, sm_scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise flash attention. q (B,Hq,Sq,D); k,v (B,Hkv,Skv,D)."""
    return flash_attention_with_lse(q, k, v, causal=causal, sm_scale=sm_scale)[0]
