"""Dataset execution knobs and the device-prefetch window.

Port of two pieces of `ray_tpu/data/dataset.py`: `DataContext` (only its
`target_batch_prefetch`, with JAX's default; the other knobs come with the
streaming `Dataset`, ROADMAP A6) and `_torch_batch_stream`, the
counterpart of `_jax_batch_stream`: a window of `target_batch_prefetch`
batches copied to the device ahead of the consumer, whose first batch
yields as soon as its copy is enqueued.

On a CUDA device each batch is pinned and copied with `non_blocking=True`
on a side stream, which records an event; when the batch is handed over,
the consumer's stream waits on that event (the host does not) and every
device tensor is marked as used on the consumer's stream
(`record_stream`), so the allocator does not hand its memory back to the
side stream while the consumer's kernels may still read it. The pinned
source is held with the batch until the batch is handed over; after that
PyTorch's pinned-memory allocator keeps the block until the copy's event
has passed. On the CPU a batch is wrapped without a copy.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import ClassVar, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from .._device import resolve_device

Block = Dict[str, np.ndarray]  # a dict of equal-length numpy columns


@dataclasses.dataclass
class DataContext:
    """Execution knobs (reference DataContext, data/context.py:226). The
    port reads the device-prefetch window only; the streaming `Dataset`'s
    knobs come with it (ROADMAP A6)."""

    target_batch_prefetch: int = 2  # device batches in flight

    _default: ClassVar[Optional["DataContext"]] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._default is None:
            cls._default = cls()
        return cls._default


class DeviceBatch(dict):
    """A batch of device tensors (column -> tensor). `ready` is the event
    its copies recorded on the side stream (None on the CPU): waiting on
    it lands the batch on the host's clock without waiting for the
    consumer's queued work."""

    ready: Optional[torch.cuda.Event] = None


def _torch_batch_stream(
    batch_iter: Iterator[Block],
    prefetch: int,
    device: Union[str, torch.device],
    columns: Optional[List[str]],
) -> Iterator[DeviceBatch]:
    """Device-prefetch window over a host batch iterator on `device`
    (resolved now: a missing CUDA device raises here, not at the first
    batch). The FIRST batch yields the moment its copy is enqueued, then
    the window tops up to `prefetch` batches behind the consumer's step —
    overlap without paying the whole window before step 0."""
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def to_device(batch: Block):
        sel = {k: batch[k] for k in (columns or batch.keys())}
        if side is None:
            return DeviceBatch({k: torch.as_tensor(v) for k, v in sel.items()}), ()
        hosts = [torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for v in sel.values()]
        with torch.cuda.stream(side):
            out = DeviceBatch({k: h.to(dev, non_blocking=True) for k, h in zip(sel, hosts)})
            out.ready = torch.cuda.Event()
            out.ready.record(side)
        return out, hosts

    def hand_over(entry) -> DeviceBatch:
        out, _hosts = entry  # the pinned sources die with the entry, after the copies' event
        if side is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(out.ready)
            for t in out.values():
                t.record_stream(consumer)
        return out

    def stream() -> Iterator[DeviceBatch]:
        it = iter(batch_iter)
        window: deque = deque()
        exhausted = False

        def top_up(target: int) -> None:
            nonlocal exhausted
            while not exhausted and len(window) < target:
                try:
                    window.append(to_device(next(it)))
                except StopIteration:
                    exhausted = True

        top_up(1)  # time-to-first-step pays ONE transfer, not the window
        while window:
            yield hand_over(window.popleft())
            top_up(max(1, prefetch))

    return stream()
