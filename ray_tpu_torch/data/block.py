"""Blocks: the unit of data movement.

Port of `ray_tpu/data/block.py` (numpy only; `batches_from_blocks` copies
each row once where JAX's copies a block's remainder for every batch). A block is a dict of
equal-length numpy arrays (columnar, zero-copy slicing); the hot
consumer pins a batch of rows and copies it to the card
(`data/dataset.py` `_torch_batch_stream`), and numpy is the shortest path
there. Arrow is an optional import for parquet IO, not the in-memory
substrate.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

Block = Dict[str, np.ndarray]


def block_num_rows(block: Block) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_nbytes(block: Block) -> int:
    return sum(v.nbytes for v in block.values())


def block_slice(block: Block, start: int, stop: int) -> Block:
    return {k: v[start:stop] for k, v in block.items()}


def block_concat(blocks: Sequence[Block]) -> Block:
    if not blocks:
        return {}
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_take(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def block_from_items(items: Sequence[Any]) -> Block:
    """Rows → columnar. dict rows become columns; scalars become 'item'."""
    if not items:
        return {}
    first = items[0]
    if isinstance(first, dict):
        return {k: np.asarray([it[k] for it in items]) for k in first}
    return {"item": np.asarray(list(items))}


def block_to_items(block: Block) -> List[Any]:
    if not block:
        return []
    keys = list(block.keys())
    n = block_num_rows(block)
    if keys == ["item"]:
        return [block["item"][i] for i in range(n)]
    return [{k: block[k][i] for k in keys} for i in range(n)]


def batches_from_blocks(
    blocks: Iterator[Block], batch_size: int, *, drop_last: bool = False
) -> Iterator[Block]:
    """Re-chunk a block stream into exact-size batches across boundaries.

    Each batch is a copy of its rows (a consumer may write to it), and
    the buffered blocks are concatenated once per arriving block: JAX's
    version re-concatenates the remainder for every batch, which copies
    a block of R rows about R**2 / (2 * batch_size) row-times."""
    buf: List[Block] = []
    buffered = 0
    for block in blocks:
        n = block_num_rows(block)
        if n == 0:
            continue
        buf.append(block)
        buffered += n
        if buffered < batch_size:
            continue
        merged = block_concat(buf) if len(buf) > 1 else buf[0]
        start = 0
        while buffered - start >= batch_size:
            yield {k: v[start:start + batch_size].copy() for k, v in merged.items()}
            start += batch_size
        rest = block_slice(merged, start, buffered)
        buf = [rest] if block_num_rows(rest) else []
        buffered -= start
    if buffered and not drop_last:
        yield block_concat(buf)
