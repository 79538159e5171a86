#!/usr/bin/env python3
"""Where the port's serving time goes on one GPU.

    python3 torch_serve_profile.py

Serves the same 8 greedy Llama-3-8B requests as chip_smoke.py (random bf16
weights from seed 0, prompts of 64-900 tokens, 32 new tokens each) through
the pipelined engine, every pass captured as a CUDA graph up front, under
torch.profiler, and prints: the capture time and the memory after it; the
wall time of the run, the device's busy time (the sum of the times of the
kernels and copies that ran on the card; host ops, whose device time would
count their kernels again, are left out) and its idle share; each graph's
replays and the kernel launches they made (replays x the launches its
capture recorded); the host's CUDA runtime calls (graph launches, eager
kernel launches, copies, synchronisations); the drain thread's reads
(entries a read, seconds waiting on the card); the ragged kernels' device time and share (the
split decode walk, its combine and the tile kernel summed, each also
listed), and the device time by kernel. The profiler adds host time per
operation, so the idle share read here is an upper bound of the
unprofiled run's. Needs one CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import get_config
from ray_tpu_torch.ops import KERNELS
from ray_tpu_torch.ops._build import build_all
from ray_tpu_torch.serve.llm import LLMServer, PagedConfig, PagedEngineConfig


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    build_all(KERNELS)
    config = get_config("llama3-8b").replace(param_dtype=torch.bfloat16)
    server = LLMServer(config, engine_config=PagedEngineConfig(max_slots=8, precompile=True,
                                                               paged=PagedConfig()),
                       seed=0, device="cuda")
    engine = server.engine
    print(f"{len(engine.passes())} graphs captured in {engine.capture_s:.3f} s; after capture "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    try:
        server.generate({"prompt_tokens": [1] * 64, "max_tokens": 2})
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, config.vocab_size, n).tolist()
                   for n in np.linspace(64, 900, 8).astype(int)]
        torch.cuda.synchronize()
        stats0, drains0 = engine.stats(), len(engine.drain_log)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            streams = [server.engine.submit(p, max_tokens=32) for p in prompts]
            outs = [s.result(timeout=600) for s in streams]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        assert all(len(o) == 32 for o in outs)
        stats = {k: v - stats0.get(k, 0.0) for k, v in engine.stats().items()}
        drains = engine.drain_log[drains0:]
    finally:
        server.shutdown()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in events)
    print(f"wall {wall:.4f} s, device busy {busy_us / 1e6:.4f} s, "
          f"idle share {1 - busy_us / 1e6 / wall:.4f} (profiled run)")
    replays = {k[len("passes."):]: int(v) for k, v in stats.items() if k.startswith("passes.")}
    launches = {k[len("launches."):]: int(v) for k, v in stats.items() if k.startswith("launches.")}
    print(f"mixed ticks {stats['mixed_ticks']:.0f}, decode blocks {stats['decode_blocks']:.0f}; "
          f"graph replays {replays}; launches through the graphs {launches}")
    # the host's CUDA runtime calls in the run: graph launches, eager kernel
    # launches, copies, and waits (the loop must make no stream sync)
    api = {e.key: e.count for e in prof.key_averages()
           if e.key.startswith(("cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpy",
                                "cudaStreamSynchronize", "cudaEventSynchronize",
                                "cudaDeviceSynchronize"))}
    print(f"host CUDA runtime calls {api}")
    waits = [t for _, t in drains]
    print(f"drain thread: {len(drains)} reads of {sum(n for n, _ in drains)} entries "
          f"(at most {max((n for n, _ in drains), default=0)} a read), {sum(waits):.4f} s "
          f"waiting on the card, longest wait {max(waits, default=0.0):.4f} s")
    ragged = [e for e in events if "ragged" in e.key]
    ragged_us = sum(_device_us(e) for e in ragged)
    print(f"ragged kernels {ragged_us / 1e3:.3f} ms, share {ragged_us / busy_us:.4f}: "
          + ", ".join(f"{e.key[:60]} {_device_us(e) / 1e3:.3f} ms x{e.count}" for e in ragged))
    rows = sorted(events, key=_device_us, reverse=True)[:15]
    table = [{"name": e.key[:90], "device_ms": _device_us(e) / 1e3, "calls": e.count,
              "share": _device_us(e) / busy_us} for e in rows]
    for row in table:
        print(f"  {row['device_ms']:10.3f} ms  {row['share']:.4f}  x{row['calls']:<6d} {row['name']}")
    print(json.dumps({"wall_s": wall, "device_busy_s": busy_us / 1e6, "replays": replays,
                      "launches": launches, "drain_reads": len(drains), "runtime_calls": api,
                      "capture_s": engine.capture_s,
                      "ragged_ms": ragged_us / 1e3, "ragged_share": ragged_us / busy_us,
                      "top": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
