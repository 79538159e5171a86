"""Training losses: cross entropy with optional z-loss, computed in float32.

Port of `ray_tpu/ops/losses.py`. The target logit is gathered first and
subtracted from the logsumexp, so the (B, S, V) f32 log-probabilities are
never formed; `fused_linear_cross_entropy` goes further and never forms
the (B, S, V) logits, running the LM head and the loss chunk by chunk
under `torch.utils.checkpoint` (the counterpart of `jax.checkpoint` in the
JAX scan body). Plain PyTorch: these functions reach no kernel of the
TPU package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint


def z_loss(logits: torch.Tensor) -> torch.Tensor:
    """Auxiliary z-loss (mean logsumexp^2): keeps the logit scale in check."""
    return torch.logsumexp(logits.float(), dim=-1).square().mean()


def cross_entropy_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    z_loss_coeff: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE. logits (..., V), targets (...) int. Returns
    (mean_loss, num_tokens) as f32 tensors. mask=0 drops a position."""
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1, keepdim=True)
    tgt = logits32.gather(-1, targets[..., None].long())
    nll = (logz - tgt)[..., 0]
    if mask is not None:
        mask_f = mask.float()
        num = mask_f.sum().clamp(min=1.0)
        loss = (nll * mask_f).sum() / num
    else:
        num = torch.tensor(float(nll.numel()), device=nll.device)
        loss = nll.mean()
    if z_loss_coeff:
        lse2 = logz[..., 0].square()
        zl = (lse2 * mask.float()).sum() / num if mask is not None else lse2.mean()
        loss = loss + z_loss_coeff * zl
    return loss, num


# bytes the dense loss path keeps live per logit element: the bf16 logits
# of the head product, their f32 upcast, and the f32 softmax the backward
# forms (the same estimate as the JAX package's)
_DENSE_LOSS_BYTES_PER_LOGIT = 2 + 4 + 4
_AUTO_CHUNK_HBM_FRACTION = 0.8  # headroom for params, optimizer state, activations
_CHUNK_CANDIDATES = (512, 256, 128)


def auto_loss_chunk(
    batch_per_device: int,
    seq: int,
    vocab: int,
    hbm_bytes: Optional[int] = None,
    *,
    device: Union[str, torch.device, None] = None,
) -> int:
    """The fused-linear-CE chunk size (0 = dense) from the logits working
    set against the device's memory: dense while the estimate stays under
    80% of it, else the first of 512, 256, 128 that divides `seq`.

    hbm_bytes None reads the CUDA device's total memory (`device`, default
    the current CUDA device); on the CPU there is no memory cliff to dodge
    and the answer is 0 (dense), as JAX's is on its CPU backend."""
    if hbm_bytes is None:
        hbm_bytes = _device_hbm_bytes(device)
    if not hbm_bytes:
        return 0
    est = batch_per_device * seq * vocab * _DENSE_LOSS_BYTES_PER_LOGIT
    if est <= _AUTO_CHUNK_HBM_FRACTION * hbm_bytes:
        return 0
    for chunk in _CHUNK_CANDIDATES:
        if seq % chunk == 0:
            return chunk
    return 0


def _device_hbm_bytes(device: Union[str, torch.device, None]) -> int:
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return 0
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.get_device_properties(dev or torch.cuda.current_device()).total_memory)


def _chunk_loss(xc, head, tc, mc):
    logits32 = (xc @ head).float()
    logz = torch.logsumexp(logits32, dim=-1, keepdim=True)
    nll = -(logits32 - logz).gather(-1, tc[..., None].long())[..., 0]
    return (nll * mc).sum(), (logz[..., 0].square() * mc).sum(), mc.sum()


def fused_linear_cross_entropy(
    x: torch.Tensor,
    head: torch.Tensor,
    targets: torch.Tensor,
    *,
    chunk: int = 256,
    mask: Optional[torch.Tensor] = None,
    z_loss_coeff: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LM-head product + CE over sequence chunks: each chunk's logits live
    only inside a checkpointed function, forward and backward, at the cost
    of one more head product per chunk in the backward.

    x (B, S, E) pre-head hidden states; head (E, V); targets (B, S). Same
    return contract as cross_entropy_loss. S % chunk must be 0."""
    b, s, _ = x.shape
    if s % chunk:
        raise ValueError(f"seq len {s} not divisible by loss chunk {chunk}")
    if mask is not None:
        mask_f = mask.float()
    else:
        mask_f = torch.ones((b, s), dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    total_nll, total_zl, num = zero, zero, zero
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        nll, zl, n = checkpoint(
            _chunk_loss, x[:, sl], head, targets[:, sl], mask_f[:, sl], use_reentrant=False
        )
        total_nll, total_zl, num = total_nll + nll, total_zl + zl, num + n
    num = num.clamp(min=1.0)
    loss = total_nll / num
    if z_loss_coeff:
        loss = loss + z_loss_coeff * (total_zl / num)
    return loss, num
