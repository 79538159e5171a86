"""Ragged paged attention: ONE kernel launch for mixed prefill + decode.

Port of `ray_tpu/ops/ragged_paged_attention.py`. The CUDA kernel
(`csrc/ragged_paged_attention.cu`) replaces the Pallas TPU kernel
`_ragged_kernel` / `_ragged_pallas`; `ragged_reference_attention` is its
plain PyTorch version, a gather over block tables that replays the
kernel's page schedule (same mask constant, same plain exp, same
online-softmax update order).

Layout (as in the JAX module):

- q is TOKEN-MAJOR with heads leading: (Hq, T, D). T is the concatenation
  of per-sequence q REGIONS, each a whole number of `block_q` rows
  (`starts`/`counts`, in block units). A sequence's real rows are the
  first `q_lens[s]` of its region.
- K/V come straight from the paged pool, (Hkv, P, ps, D); `tables`
  (S, maxP) holds absolute page ids (callers fold per-layer offsets in).
  Unused table entries must point at the scratch page 0.
- The query at region row r of sequence s sits at token position
  kv_lens[s] - q_lens[s] + r; causal masking and the kv-length bound both
  derive from that.

Dispatch is by device: a CUDA tensor launches the kernel (or raises on a
shape or dtype it does not take); a CPU tensor takes the plain version.
The tensor-parallel `mesh` path of the JAX module is not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import Kernel

_NEG_INF = -1e30  # finite "minus infinity": exp() lands at exactly 0.0

RAGGED = Kernel(
    "ragged_paged_attention",
    "ragged_paged_attention.cu",
    "ragged_paged_attention_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


# --------------------------------------------------------------- reference


def ragged_reference_attention(
    q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables,
    *, block_q: int, max_q_blocks: int,
):
    """Gather-based plain version that REPLAYS the kernel's page schedule.

    Pages are gathered through the block tables, and the online-softmax
    update runs per page in the kernel's op order, vectorized over
    (Hq, S, q-block). q must already be scaled (the dispatcher does it).
    """
    hq, t, d = q.shape
    hkv = k_pages.shape[0]
    ps = k_pages.shape[2]
    s_count, max_pages = tables.shape
    groups = hq // hkv
    dev = q.device
    starts, counts = starts.long(), counts.long()
    q_lens, kv_lens = q_lens.long(), kv_lens.long()
    tables = tables.long()

    # (S, MAXQB) region-clamped block indices -> q blocks (Hq, S, MAXQB, bq, D)
    qb_idx = torch.arange(max_q_blocks, device=dev)[None, :]
    blk = starts[:, None] + torch.minimum(qb_idx, counts[:, None] - 1)
    q_blocks = q.reshape(hq, t // block_q, block_q, d)[:, blk].float()
    # gathered pages: (Hkv, S, maxP, ps, D)
    k_seq = k_pages[:, tables]
    v_seq = v_pages[:, tables]
    if groups > 1:
        k_seq = torch.repeat_interleave(k_seq, groups, dim=0)
        v_seq = torch.repeat_interleave(v_seq, groups, dim=0)

    row = qb_idx[:, :, None] * block_q + torch.arange(block_q, device=dev)[None, None, :]
    pos = kv_lens[:, None, None] - q_lens[:, None, None] + row  # (S, MAXQB, bq)
    row_valid = row < q_lens[:, None, None]
    pos_hi = (
        kv_lens[:, None] - q_lens[:, None]
        + torch.minimum((qb_idx + 1) * block_q, q_lens[:, None]) - 1
    )  # (S, MAXQB)

    stat = (hq, s_count, max_q_blocks, block_q, 1)
    m = torch.full(stat, _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(stat, dtype=torch.float32, device=dev)
    acc = torch.zeros((hq, s_count, max_q_blocks, block_q, d), dtype=torch.float32, device=dev)
    for kb in range(max_pages):
        k = k_seq[:, :, kb].float()  # (Hq, S, ps, D)
        v = v_seq[:, :, kb].float()
        logits = torch.einsum("hsbqd,hskd->hsbqk", q_blocks, k)
        col = kb * ps + torch.arange(ps, device=dev)
        mask = (
            row_valid[None, :, :, :, None]
            & (col[None, None, None, None, :] <= pos[None, :, :, :, None])
            & (col[None, None, None, None, :] < kv_lens[None, :, None, None, None])
        )
        logits = torch.where(mask, logits, _NEG_INF)
        m_cur = logits.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("hsbqk,hskd->hsbqd", p, v)
        # the kernel's per-block `work` guard (pages past the causal frontier
        # of the block's last real row are never visited)
        work = ((qb_idx * block_q < q_lens[:, None]) & (kb * ps <= pos_hi))[
            None, :, :, None, None
        ]
        m = torch.where(work, m_new, m)
        l = torch.where(work, l_new, l)
        acc = torch.where(work, acc_new, acc)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out_blocks = (acc / safe_l).to(q.dtype)  # (Hq, S, MAXQB, bq, D)

    # scatter region blocks back to token-major rows; blocks beyond a region
    # (qb >= counts) alias its last block and must not write
    valid = (qb_idx < counts[:, None]).reshape(-1)
    flat_blk = blk.reshape(-1)[valid]
    out = torch.zeros((hq, t // block_q, block_q, d), dtype=q.dtype, device=dev)
    out[:, flat_blk] = out_blocks.reshape(hq, -1, block_q, d)[:, valid]
    return out.reshape(hq, t, d)


# ------------------------------------------------------------------ kernel


def _ragged_cuda(q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables,
                 *, block_q: int, max_q_blocks: int):
    """Launch the CUDA kernel on pre-scaled q; returns (Hq, T, D)."""
    tensors = (q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables)
    if any(x.device != q.device for x in tensors):
        raise ValueError("ragged kernel: every argument must be on q's CUDA device")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"ragged kernel takes float32 or bfloat16 q/pages of one dtype, got "
            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    hq, t, d = q.shape
    hkv, num_pages, ps, d_k = k_pages.shape
    s_count, max_pages = tables.shape
    if v_pages.shape != k_pages.shape or d_k != d or hq % hkv:
        raise ValueError(
            f"ragged kernel: bad shapes q{tuple(q.shape)} pages{tuple(k_pages.shape)}"
        )
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"ragged kernel supports head_dim in {_KERNEL_HEAD_DIMS}, got {d}")
    if (hq // hkv) * block_q > 64 or ps > 128:
        raise ValueError(
            f"ragged kernel takes groups*block_q <= 64 and page_size <= 128, got "
            f"{hq // hkv}*{block_q} and {ps}"
        )
    descs = (starts, counts, q_lens, kv_lens)
    if any(x.shape != (s_count,) for x in descs):
        raise ValueError("ragged kernel: descriptors must be (S,) like tables' rows")
    if any(x.dtype != torch.int32 for x in descs + (tables,)):
        raise TypeError("ragged kernel: descriptors and tables must be int32")
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    starts, counts, q_lens, kv_lens, tables = (
        x.contiguous() for x in (starts, counts, q_lens, kv_lens, tables)
    )
    # rows outside every region stay zero, as in the plain version
    out = torch.zeros_like(q)
    RAGGED.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), q_lens.data_ptr(), kv_lens.data_ptr(), tables.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], d, t, num_pages, ps, max_pages,
        block_q, hq // hkv, s_count, hkv, max_q_blocks,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out


# ----------------------------------------------------------------- dispatch


def ragged_paged_attention(
    q: torch.Tensor,           # (Hq, T, D) token-major, per-seq block regions
    k_pages: torch.Tensor,     # (Hkv, P, ps, D)
    v_pages: torch.Tensor,
    starts: torch.Tensor,      # (S,) int32 region starts, block_q units
    counts: torch.Tensor,      # (S,) int32 region sizes, block_q units (>= 1)
    q_lens: torch.Tensor,      # (S,) int32 real q rows (0 = inactive lane)
    kv_lens: torch.Tensor,     # (S,) int32 total kv length per sequence
    tables: torch.Tensor,      # (S, maxP) int32 absolute page ids
    *,
    block_q: int = 8,
    sm_scale: Optional[float] = None,
    max_q_blocks: Optional[int] = None,
) -> torch.Tensor:
    """Causal ragged paged attention over a page pool; returns (Hq, T, D).

    Query row r of a region sits at absolute position kv_len - q_len + r,
    so the same descriptor covers prefill chunks (q_len = chunk fill),
    decode lanes (q_len = 1) and verify regions (q_len = K).
    """
    hq, t, d = q.shape
    if t % block_q:
        raise ValueError(
            f"token rows ({t}) must divide by block_q ({block_q}): regions "
            "are dispatched in block_q-row units"
        )
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if max_q_blocks is None:
        # T is exactly the sum of the regions, so T // block_q bounds any one
        max_q_blocks = t // block_q
    # q is scaled and rounded to its own dtype BEFORE the kernel, as on the TPU
    q = (q.float() * sm_scale).to(q.dtype)
    args = (q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables)
    if q.is_cuda:
        return _ragged_cuda(*args, block_q=block_q, max_q_blocks=max_q_blocks)
    return ragged_reference_attention(*args, block_q=block_q, max_q_blocks=max_q_blocks)
