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
The CUDA kernels scale q themselves as they load it, to exactly the
dispatcher's `bf16(f32(q) * f32(sm_scale))`, so the serve loop spends no
elementwise launches on it; the plain version takes q already scaled.
The bf16 decode path (`max_q_blocks == 1`) splits each lane's kv walk
over several blocks and combines their partials in a second kernel, in
an f32 workspace this wrapper allocates (`_split_plan`). The
tensor-parallel `mesh` path of the JAX module is not ported yet.
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
    [ctypes.c_void_p] * 11 + [ctypes.c_float] + [ctypes.c_int] * 13 + [ctypes.c_void_p],
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
_TILE_COLS = 64  # kv positions per tile of the bf16 kernels
# decode splits: aim at this many blocks per SM. At 178 registers a thread
# (D 128) an SM holds two blocks of the walk, so 2 is one wave; splitting
# further (shorter walks in a second wave) measured slower on the H100:
# 0.0305 ms at 4 against 0.0262 at 2 for chip_smoke.py's decode case
# (`torch_flash_ab.py ragged --waves`)
_SPLIT_TARGET_WAVES = 2
_MIN_TILES_PER_SPLIT = 2
_MAX_SPLITS = 32  # the combine gives each split one lane of a warp
# RAGGED's launches by the call's shape, counted beside RAGGED.launches:
# decode steps (max_q_blocks == 1; bf16: the split walk and the combine)
# and mixed ticks (max_q_blocks > 1; bf16: the tile kernel)
LAUNCHES_BY_KIND = {"decode": 0, "mixed": 0}


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
    # (qb >= counts) alias its last block and must not write: they go to a
    # dump block past the end (no boolean indexing, which would make the
    # host wait on the device and cannot be captured in a CUDA graph)
    n_blocks = t // block_q
    valid = (qb_idx < counts[:, None]).reshape(-1)
    dest = torch.where(valid, blk.reshape(-1), n_blocks)
    out = torch.zeros((hq, n_blocks + 1, block_q, d), dtype=q.dtype, device=dev)
    out[:, dest] = out_blocks.reshape(hq, -1, block_q, d)
    return out[:, :n_blocks].reshape(hq, t, d)


# ------------------------------------------------------------------ kernel


def _split_plan(num_seqs: int, num_kv_heads: int, max_pages: int, page_size: int,
                num_sms: int):
    """(n_splits, tiles_per_split) of the bf16 decode kernel, from sizes
    the host knows: each lane's kv walk (at most max_pages pages, in
    64-position tiles) is cut into runs of tiles_per_split tiles (at least
    2), enough of them that lanes x kv heads x splits reach about
    _SPLIT_TARGET_WAVES blocks per SM, and at most _MAX_SPLITS."""
    tiles = -(-max_pages * page_size // _TILE_COLS)
    want = max(1, -(-_SPLIT_TARGET_WAVES * num_sms // (num_seqs * num_kv_heads)))
    want = min(want, _MAX_SPLITS)
    per_split = max(_MIN_TILES_PER_SPLIT, -(-tiles // want))
    return max(1, -(-tiles // per_split)), per_split


def _workspace_layout(rows: int, head_dim: int):
    """(floats, acc_offset) of the decode workspace: the (m, l) pair of
    every partial row, then from acc_offset their head_dim accumulator
    columns. The pairs are rounded up to whole 16-byte units, so the
    accumulators start on 16 bytes for the combine's float4 loads (D 128)
    whatever the row count."""
    acc_offset = 4 * -(-rows // 2)
    return acc_offset + rows * head_dim, acc_offset


def _decode_workspace(q, num_seqs: int, num_kv_heads: int, max_pages: int, page_size: int,
                      block_q: int):
    """The bf16 decode path's split plan and f32 workspace: (workspace,
    ws_ml and ws_acc addresses, n_splits, tiles_per_split), laid out by
    `_workspace_layout`. It may be freed once the launch is queued, since
    the caching allocator hands it out again only to work queued after it
    on the same stream."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_splits, per_split = _split_plan(num_seqs, num_kv_heads, max_pages, page_size, sms)
    rows = num_seqs * num_kv_heads * n_splits * (q.shape[0] // num_kv_heads) * block_q
    floats, acc_offset = _workspace_layout(rows, q.shape[-1])
    workspace = torch.empty(floats, dtype=torch.float32, device=q.device)
    return (workspace, workspace.data_ptr(), workspace[acc_offset:].data_ptr(), n_splits,
            per_split)


def _ragged_cuda(q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables,
                 *, block_q: int, max_q_blocks: int, sm_scale: float):
    """Launch the CUDA kernels on UNSCALED q (they scale it by sm_scale as
    they load it); returns (Hq, T, D)."""
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
    groups = hq // hkv
    if groups * block_q > 64 or ps > 128:
        raise ValueError(
            f"ragged kernel takes groups*block_q <= 64 and page_size <= 128, got "
            f"{groups}*{block_q} and {ps}"
        )
    descs = (starts, counts, q_lens, kv_lens)
    if any(x.shape != (s_count,) for x in descs):
        raise ValueError("ragged kernel: descriptors must be (S,) like tables' rows")
    if any(x.dtype != torch.int32 for x in descs + (tables,)):
        raise TypeError("ragged kernel: descriptors and tables must be int32")
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("ragged kernel: q and the pages must start on 16-byte boundaries")
    starts, counts, q_lens, kv_lens, tables = (
        x.contiguous() for x in (starts, counts, q_lens, kv_lens, tables)
    )
    # rows outside every region stay zero, as in the plain version
    out = torch.zeros_like(q)
    workspace, ws_ml, ws_acc, n_splits, per_split = None, 0, 0, 0, 0
    if q.dtype == torch.bfloat16 and max_q_blocks == 1 and s_count:
        workspace, ws_ml, ws_acc, n_splits, per_split = _decode_workspace(
            q, s_count, hkv, max_pages, ps, block_q)
    RAGGED.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), q_lens.data_ptr(), kv_lens.data_ptr(), tables.data_ptr(),
        out.data_ptr(), ws_acc, ws_ml, float(sm_scale), _DTYPE_CODES[q.dtype], d, t,
        num_pages, ps, max_pages, block_q, groups, s_count, hkv, max_q_blocks,
        n_splits, per_split, torch.cuda.current_stream(q.device).cuda_stream,
    )
    LAUNCHES_BY_KIND["decode" if max_q_blocks == 1 else "mixed"] += 1
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
    if q.is_cuda:
        # the kernels scale q as they load it, to the same bf16(f32(q) * f32(scale))
        return _ragged_cuda(q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables,
                            block_q=block_q, max_q_blocks=max_q_blocks, sm_scale=sm_scale)
    # q is scaled and rounded to its own dtype BEFORE the kernel, as on the TPU
    q = (q.float() * sm_scale).to(q.dtype)
    return ragged_reference_attention(q, k_pages, v_pages, starts, counts, q_lens, kv_lens,
                                      tables, block_q=block_q, max_q_blocks=max_q_blocks)
