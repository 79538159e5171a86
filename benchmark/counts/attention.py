"""Frozen operation and byte counts of the port's attention kernels,
worked out from shapes alone (never from the port's code), so a change to
the program cannot change its own yardstick.

Each input byte is counted once as read and each output byte once as
written, whatever a kernel reads again; operations count the unmasked
(query, key) pairs, 2 * D operations a pair for each product.

- K5, ragged paged attention (`ragged_call`): q's real rows, every output
  row of the regions, the K and V pages of each lane's walk, the int32
  descriptors; 4 * Hq * D operations per pair (QK and PV). `ragged_lane`
  is one lane's share, without the call's descriptors and padding rows,
  which is how a run's work adds up when the calls are not observed one
  by one.
- K1, the flash forward (`flash_fwd`): q, k, v read, the output and its
  f32 log-sum-exp written.
- K2, the flash backward (`flash_bwd`): dkv (the S, dP, dV and dK
  products) and dq (S, dP and dQ), each reading q, dO, k, v, lse and
  delta, and writing its own gradients.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

Cost = Tuple[float, float]  # (operations, bytes)


def causal_pairs(s: int) -> float:
    return s * (s + 1) / 2


def ragged_call(q_lens: Sequence[int], kv_lens: Sequence[int], counts: Sequence[int], *,
                block_q: int, max_pages: int, hq: int, hkv: int, d: int, page_size: int,
                itemsize: int = 2) -> Cost:
    """One K5 launch over regions of `counts[s]` q blocks of `block_q` rows,
    whose first `q_lens[s]` rows are real and sit at the last positions of
    a context of `kv_lens[s]` keys."""
    t_rows = sum(counts) * block_q
    pages = sum(math.ceil(kl / page_size) for kl in kv_lens)
    nbytes = (sum(q_lens) * hq * d * itemsize          # q's real rows
              + t_rows * hq * d * itemsize             # every output row of the regions
              + 2 * pages * hkv * page_size * d * itemsize  # K and V pages of each walk
              + 4 * len(q_lens) * 4 + 4 * len(q_lens) * max_pages)  # descriptors
    keys = sum(kl - ql + r + 1 for ql, kl in zip(q_lens, kv_lens) for r in range(ql))
    return 4.0 * hq * d * keys, float(nbytes)


def ragged_lane(q_len: int, kv_len: int, *, hq: int, hkv: int, d: int, page_size: int,
                itemsize: int = 2) -> Cost:
    """One lane of a K5 launch: its q rows read and output rows written,
    the pages of its walk, its (query, key) pairs."""
    pages = math.ceil(kv_len / page_size)
    nbytes = 2 * q_len * hq * d * itemsize + 2 * pages * hkv * page_size * d * itemsize
    keys = q_len * (kv_len - q_len) + causal_pairs(q_len)
    return 4.0 * hq * d * keys, float(nbytes)


def flash_fwd(b: int, hq: int, hkv: int, s: int, d: int, *, causal: bool = True,
              itemsize: int = 2) -> Cost:
    pairs = causal_pairs(s) if causal else s * s
    q = b * hq * s * d * itemsize
    kv = b * hkv * s * d * itemsize
    nbytes = 2 * q + 2 * kv + b * hq * s * 4  # q, k, v in; out, lse out
    return 4.0 * b * hq * d * pairs, float(nbytes)


def flash_bwd(b: int, hq: int, hkv: int, s: int, d: int, *, causal: bool = True,
              itemsize: int = 2) -> Dict[str, Cost]:
    """{"dkv": cost, "dq": cost, "both": cost} of the backward."""
    pairs = b * hq * (causal_pairs(s) if causal else s * s)
    q = b * hq * s * d * itemsize
    kv = b * hkv * s * d * itemsize
    rows = b * hq * s * 4
    reads = 2 * q + 2 * kv + 2 * rows  # q, dO, k, v, lse, delta
    return {
        "dkv": (4 * 2.0 * d * pairs, float(reads + 2 * kv)),
        "dq": (3 * 2.0 * d * pairs, float(reads + q)),
        "both": (5 * 2.0 * d * pairs, float(reads + 2 * q + 2 * kv)),
    }
