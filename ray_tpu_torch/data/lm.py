"""LM ingest: token packing for next-token training.

Port of `ray_tpu/data/lm.py`: documents → one flat token stream →
fixed-length windows, the standard GPT pretraining packing (no padding,
every position supervised), then (B, S+1) token batches on the device
through the prefetch window of `data/dataset.py`. `lm_batch_iterator`
takes any object with `iter_blocks()`: a streaming `Dataset` (ROADMAP
A2), a gang rank's `DataIterator` (`train.get_dataset_shard`), or a plain
iterable of blocks behind that method. In a multihost gang `sharding=`
(`parallel.data_sharding(mesh)`) places each batch per rank: every rank
packs the global batch and copies its own rows to its device, as JAX's
`make_array_from_process_local_data` does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Union

import numpy as np
import torch

from .dataset import Block, DataContext, DeviceBatch, _torch_batch_stream


def pack_tokens(
    blocks: Iterator[Block],
    seq_len: int,
    batch_size: int,
    *,
    column: str = "tokens",
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Pack a stream of token blocks into (batch_size, seq_len + 1) windows.

    Accepts blocks whose `column` is either a 1-D token stream or a ragged
    object array of per-document token lists; documents are concatenated
    (add separators upstream if wanted).
    """
    window = seq_len + 1
    buf = np.empty(0, dtype=np.int32)
    rows = []
    for block in blocks:
        col = block[column]
        if col.dtype == object:
            flat = np.concatenate([np.asarray(x, dtype=np.int32) for x in col]) if len(col) else np.empty(0, np.int32)
        else:
            flat = np.asarray(col, dtype=np.int32).reshape(-1)
        buf = np.concatenate([buf, flat])
        while len(buf) >= window:
            n_rows = len(buf) // window
            take = buf[: n_rows * window].reshape(n_rows, window)
            buf = buf[n_rows * window:]
            for r in take:
                rows.append(r)
                if len(rows) == batch_size:
                    yield {"tokens": np.stack(rows)}
                    rows = []
    if rows and not drop_last:
        yield {"tokens": np.stack(rows)}


def lm_batch_iterator(
    dataset_or_iterator: Any,
    seq_len: int,
    batch_size: int,
    *,
    column: str = "tokens",
    sharding=None,
    device: Union[str, torch.device] = "cuda",
) -> Iterator[DeviceBatch]:
    """Device-ready LM batches from any object with `iter_blocks()` —
    feed straight into LMTrainer.train(). Batches ride a device-prefetch
    window (the first yields as soon as its copy is enqueued; the window
    tops up behind the consumer's step) on `device` (default "cuda",
    raising without one; "cpu" wraps the numpy batches), or with
    `sharding=` this rank's rows on the sharding's mesh device."""
    packed = pack_tokens(
        dataset_or_iterator.iter_blocks(), seq_len, batch_size, column=column
    )
    prefetch = DataContext.get_current().target_batch_prefetch
    return _torch_batch_stream(packed, prefetch, device, None, sharding=sharding)
