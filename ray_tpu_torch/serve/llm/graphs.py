"""The paged engine's device passes: CUDA graphs on the card, eager on the CPU.

The JAX engine jits one program per pass (each mixed-tick bucket, each
decode-block sampler; in speculative mode each mixed bucket is a verify
pass and there are no decode blocks) and `PagedEngineConfig.precompile`
compiles them all before serving. The counterpart here is one CUDA graph per pass
(`DevicePass`): the pass's function is captured once over static input
tensors of fixed shapes, and each call copies the tick's host arrays into
those inputs and replays the graph. A graph is captured at its first call,
as jit compiles at its first call, or up front by `capture`.

- Inputs reach the card by `copy_(non_blocking=True)` from pinned staging
  tensors (`to_device`). A pinned tensor comes from PyTorch's caching host
  allocator, which records an event on the copy that reads it and hands
  the block out again only after that event: a staging buffer is never
  rewritten while a copy still reads it.
- Tensors the function closes over (the weights, the page pool, the
  engine's token vector) are captured by address: their storage must
  never be rebound. The pool and the token vector are written in place
  inside the graphs.
- The outputs are the graph's own tensors, which the next replay of the
  same pass overwrites: a caller consumes them (sampling, the fetch copy)
  on the same stream before that replay.
- Each graph has its own private memory pool.
- A capture or replay that fails raises; there is no eager retry on the
  card. On the CPU, each call runs the function eagerly on the host arrays.

A replay passes through no kernel wrapper, so the wrappers' counts
(`Kernel.launches`, the ragged `LAUNCHES_BY_KIND`) cannot see it. At
capture, a pass records the launches of each kernel and of each ragged
kind that the capture made; `launches()` gives runs x captured.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import KERNELS
from ...ops.ragged_paged_attention import LAUNCHES_BY_KIND

InputSpec = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on the card through a pinned staging
    tensor and a non-blocking copy (a copy from pageable memory would make
    the host wait for the stream), on the CPU as it is."""
    host = torch.from_numpy(arr)
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, and the ragged launches by kind
    (`ragged.decode`, `ragged.mixed`)."""
    counts = {k.name: k.launches for k in KERNELS}
    counts.update({f"ragged.{kind}": n for kind, n in LAUNCHES_BY_KIND.items()})
    return counts


class DevicePass:
    """One device pass of the engine: `fn(**inputs)` over tensors named
    and shaped by `inputs`, run as a CUDA graph on the card and eagerly on
    the CPU. `generator`, when the pass draws random numbers, is registered
    with the graph, so each replay draws new numbers."""

    def __init__(self, name: str, fn: Callable[..., Any], inputs: InputSpec,
                 device: torch.device, generator: Optional[torch.Generator] = None):
        self.name = name
        self.fn = fn
        self.inputs = inputs
        self.device = device
        self.generator = generator
        self.runs = 0       # calls: replays on the card, eager runs on the CPU
        self.captured: Dict[str, int] = {}  # launches recorded at capture
        self.capture_s = 0.0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._static: Dict[str, torch.Tensor] = {}
        self._out: Any = None

    @property
    def is_captured(self) -> bool:
        return self._graph is not None

    def run_eager(self, **arrays: np.ndarray) -> Any:
        return self.fn(**{k: to_device(v, self.device) for k, v in arrays.items()})

    def __call__(self, **arrays: np.ndarray) -> Any:
        self.runs += 1
        if self.device.type == "cpu":
            return self.run_eager(**arrays)
        if self._graph is None:
            self.capture()
        for name, arr in arrays.items():
            self._static[name].copy_(torch.from_numpy(arr).pin_memory(), non_blocking=True)
        self._graph.replay()
        return self._out

    def capture(self, stream: Optional[torch.cuda.Stream] = None) -> None:
        """Capture the pass over all-zero static inputs (callers make zeros
        inactive: every write lands in the scratch page). One eager run on
        the capture stream first builds the kernels and creates the cuBLAS
        handles and workspaces, which capture cannot allocate."""
        t0 = time.perf_counter()
        stream = stream or torch.cuda.Stream(self.device)
        self._static = {name: torch.zeros(shape, dtype=dtype, device=self.device)
                        for name, (shape, dtype) in self.inputs.items()}
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.fn(**self._static)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = launch_counts()
        # thread_local: the drain thread may wait on an event meanwhile
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            self._out = self.fn(**self._static)
        after = launch_counts()
        self.captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self._graph = graph
        self.capture_s = time.perf_counter() - t0

    def launches(self) -> Dict[str, int]:
        """Kernel launches this pass made on the card: runs x captured."""
        return {k: self.runs * n for k, n in self.captured.items()}
