"""Flash attention: CUDA kernels for Hopper + plain PyTorch paths.

Port of `ray_tpu/ops/attention.py`. The forward kernel
(`csrc/flash_attention_fwd.cu`) replaces the Pallas TPU forward
(`_fwd_kernel` / `_fwd_pallas`, and the pipelined `_fwd_pipe_tpu` that
computes the same function); its plain PyTorch version is
`_flash_fwd_plain`. The two backward kernels (`csrc/flash_attention_bwd.cu`,
`FLASH_BWD_DKV` and `FLASH_BWD_DQ`) replace `_dkv_kernel` / `_dq_kernel`
(via `_bwd_pallas`, and the pipelined `_bwd_pipe_tpu` that computes the
same gradients); their plain PyTorch version is `_flash_bwd_plain`.
`flash_attention` is a `torch.autograd.Function` over the two: the forward
kernel saves (q, k, v, out, lse) and the backward kernels recompute P
from lse, as `jax.custom_vjp` does around the Pallas calls.

Dispatch is by device: a CUDA tensor launches the kernel (or raises on a
shape or dtype it does not take); a CPU tensor takes the plain version.
There is no other fallback.

Layout convention: q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with
Hq % Hkv == 0 (grouped-query attention: q head h reads kv head
h // (Hq // Hkv), no materialized repeat on the kernel path; the dkv
kernel sums each kv head's gradient over its group in f32).

`flash_attention_with_lse` stays forward-only, as in JAX: no gradient
flows through the lse output, and a call whose inputs need one raises.
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
# q, k, v, dO, lse, delta, dk, dv | dtype, head_dim, B, Hq, Hkv, Sq, Skv, causal
# | scale*log2(e), scale | stream
FLASH_BWD_DKV = Kernel(
    "flash_attention_bwd_dkv",
    "flash_attention_bwd.cu",
    "flash_attention_bwd_dkv_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)
# q, k, v, dO, lse, delta, dq | as above
FLASH_BWD_DQ = Kernel(
    "flash_attention_bwd_dq",
    "flash_attention_bwd.cu",
    "flash_attention_bwd_dq_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_IMPLS = (None, "pallas", "pallas_pipelined")  # JAX's names; all take the kernel


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
            "flash_attention_with_lse is forward-only, as in JAX: no gradient "
            "flows through its lse output; use flash_attention for a "
            "differentiable call, or call under torch.no_grad()"
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


def _flash_bwd_plain(q, k, v, out, lse, do, causal: bool, sm_scale: float):
    """The backward kernels' function in plain PyTorch, written out (not
    autograd of a reference), so the CPU tests hold the contract the
    kernels carry out: P recomputed from the natural-log lse in base 2,
    round(P)^T dO, dS = P (dP - delta) sm_scale, round(dS) products, f32
    sums, GQA gradients summed over each kv head's group in f32 and
    rounded once. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    groups = hq // hkv
    kx, vx = _repeat_kv(k, v, hq)
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * (sm_scale * _LOG2E)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(skv, device=q.device)[None, :]
        p = torch.where(cols <= rows, torch.exp2(s - lse * _LOG2E), 0.0)
    else:
        p = torch.exp2(s - lse * _LOG2E)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vx.float())
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx.float())
    if groups > 1:
        dk = dk.view(b, hkv, groups, skv, d).sum(dim=2)
        dv = dv.view(b, hkv, groups, skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(q, k, v, *more) -> Tuple[int, int, int, int, int, int]:
    """Device, dtype and shape checks shared by the three flash kernels;
    returns (B, Hq, Hkv, Sq, Skv, D)."""
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *more))):
        raise ValueError("flash kernel: all inputs must be on one CUDA device")
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
    return b, hq, hkv, sq, skv, d


def _delta(do, out):
    """rowsum(dO * O) in f32, (B, Hq, Sq, 1). O is widened inside the
    multiply (type promotion), one cast kernel fewer than widening both;
    the products and the sum are those of the plain version, bit for bit."""
    return (do.float() * out).sum(dim=-1, keepdim=True)


def _flash_bwd_cuda(q, k, v, out, lse, do, causal: bool, sm_scale: float):
    """Launch the dkv and dq kernels; returns (dq, dk, dv). delta =
    rowsum(dO * O) is computed here in f32, as JAX computes it outside its
    kernels."""
    b, hq, hkv, sq, skv, d = _check_kernel_inputs(q, k, v, out, lse, do)
    if do.dtype != q.dtype or out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash backward: dO {do.dtype}{tuple(do.shape)} does not match q")
    if lse.dtype != torch.float32 or lse.shape != (b, hq, sq, 1):
        raise ValueError(
            f"flash backward: lse must be float32 (B, Hq, Sq, 1), got {lse.dtype}{tuple(lse.shape)}"
        )
    # dO reaches here as a view of the transposed attention output
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    lse = lse.contiguous()
    delta = _delta(do, out)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    shape_args = (_DTYPE_CODES[q.dtype], d, b, hq, hkv, sq, skv, int(causal),
                  float(sm_scale * _LOG2E), float(sm_scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    FLASH_BWD_DKV.launch(*ins, dk.data_ptr(), dv.data_ptr(), *shape_args)
    FLASH_BWD_DQ.launch(*ins, dq.data_ptr(), *shape_args)
    return dq, dk, dv


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch the CUDA forward kernel; returns (out, lse (B, Hq, Sq, 1))."""
    b, hq, hkv, sq, skv, d = _check_kernel_inputs(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq, 1), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODES[q.dtype], d, b, hq, hkv, sq, skv, int(causal),
        float(sm_scale * _LOG2E), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


def _flash_fwd(q, k, v, causal: bool, sm_scale: float):
    if causal and q.shape[2] != k.shape[2]:
        raise NotImplementedError("causal flash kernel requires Sq == Skv")
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, sm_scale)
    return _flash_fwd_plain(q, k, v, causal, sm_scale)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of JAX's `_flash` custom_vjp: the forward kernel
    saves (q, k, v, out, lse); the backward kernels recompute P from them.
    CPU tensors take the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = _flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = _flash_bwd_cuda if q.is_cuda else _flash_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row logsumexp of the
    scaled scores, shape (B, Hq, Sq, 1) float32 (natural log). Forward
    only, as in JAX."""
    _no_grad_check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _flash_fwd(q, k, v, causal, sm_scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Blockwise flash attention with a gradient. q (B,Hq,Sq,D);
    k,v (B,Hkv,Skv,D).

    implementation takes JAX's values: None, "pallas" and
    "pallas_pipelined" run the flash kernels (forward and both backward
    kernels) on CUDA tensors and their plain versions on CPU tensors;
    "xla" runs `mha_reference` under torch autograd."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if implementation == "xla":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if implementation not in _KERNEL_IMPLS:
        raise ValueError(f"unknown attention implementation: {implementation!r}")
    return _FlashAttention.apply(q, k, v, causal, sm_scale)
