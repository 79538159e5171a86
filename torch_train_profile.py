#!/usr/bin/env python3
"""Where the port's training step time goes on one GPU.

    python3 torch_train_profile.py

Runs the train path of chip_smoke.py (GPT-2 124M at full width and depth,
f32 master weights from seed 0, bf16 compute, one fixed 8 x 1025 batch,
`make_train_step`) for a few warm-up steps and a few unprofiled steps
(their median wall time), then PROFILED_STEPS steps under torch.profiler,
and prints: the profiled wall time, the device's busy time (the sum of
the times of the kernels and copies that ran on the card) and its idle
share, the device time by group (the port's flash kernels, matrix
products, the rest) and by kernel, and the two step phases
("steplog.fwd_bwd_compute", "steplog.optimizer_update") timed with CUDA
events on unprofiled steps. The profiler adds host time per operation, so
the idle share read here is an upper bound of the unprofiled run's.
Needs one CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import get_config
from ray_tpu_torch.ops import KERNELS
from ray_tpu_torch.ops._build import build_all
from ray_tpu_torch.train import (
    create_train_state,
    default_optimizer,
    global_norm,
    loss_and_grads,
    make_train_step,
)

WARMUP_STEPS = 3
TIMED_STEPS = 5
PROFILED_STEPS = 5
GROUPS = (  # first match wins, on the kernel's name
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_fwd", ("flash_fwd",)),
    ("matmul", ("gemm", "nvjet", "sm90_xmma", "cutlass", "cublas")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
    ("copy", ("memcpy", "memset", "copy")),
)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _device_events(averages) -> list:
    """Kernels and copies that ran on the card. Host ops are left out (their
    device time would count their kernels a second time), and so are the
    device-side copies of host ranges ("steplog.*" labels), which share a
    name with a host event."""
    host = {e.key for e in averages if getattr(e, "device_type", None) == DeviceType.CPU}
    return [e for e in averages if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.key not in host and _device_us(e) > 0]


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    build_all(KERNELS)
    config = get_config("gpt2-small")
    opt = default_optimizer(1e-3, warmup_steps=2, total_steps=20)
    state = create_train_state(config, opt, 0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, config.vocab_size, (8, 1025), generator=gen, device="cuda")
    step = make_train_step(config, opt, device="cuda")
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, {"tokens": tokens})
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        state, _ = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    # the step's two phases, as make_train_step runs them, on CUDA events
    phase_ms = {"steplog.fwd_bwd_compute": [], "steplog.optimizer_update": []}
    for _ in range(TIMED_STEPS):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        _, _, grads = loss_and_grads(config, state.params, tokens)
        marks[1].record()
        global_norm(grads)
        state.opt_state = opt.update(grads, state.opt_state, state.params)
        marks[2].record()
        torch.cuda.synchronize()
        phase_ms["steplog.fwd_bwd_compute"].append(marks[0].elapsed_time(marks[1]))
        phase_ms["steplog.optimizer_update"].append(marks[1].elapsed_time(marks[2]))
    phases = {k: statistics.median(v) for k, v in phase_ms.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    loss = metrics["loss"].item()
    events = _device_events(prof.key_averages())
    busy_us = sum(_device_us(e) for e in events)
    print(f"unprofiled step median {statistics.median(times) * 1e3:.3f} ms over {TIMED_STEPS} steps; "
          f"profiled: {PROFILED_STEPS} steps, wall {wall:.4f} s, device busy {busy_us / 1e6:.4f} s, "
          f"idle share {1 - busy_us / 1e6 / wall:.4f}; last loss {loss:.4f}")
    groups = {}
    for e in events:
        g = groups.setdefault(_group(e.key), [0.0, 0])
        g[0] += _device_us(e)
        g[1] += e.count
    print("device time by group, per step:")
    for name, (us, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3 / PROFILED_STEPS:10.3f} ms  {us / busy_us:.4f}  "
              f"x{calls / PROFILED_STEPS:<8.1f} {name}")
    for key, ms in phases.items():
        print(f"  phase {key}: {ms:.3f} ms per step (CUDA events, unprofiled, median of {TIMED_STEPS})")
    rows = sorted(events, key=_device_us, reverse=True)[:20]
    table = [{"name": e.key[:90], "device_ms_per_step": _device_us(e) / 1e3 / PROFILED_STEPS,
              "calls_per_step": e.count / PROFILED_STEPS, "share": _device_us(e) / busy_us}
             for e in rows]
    for row in table:
        print(f"  {row['device_ms_per_step']:10.3f} ms  {row['share']:.4f}  "
              f"x{row['calls_per_step']:<8.1f} {row['name']}")
    print(json.dumps({
        "step_ms_unprofiled": statistics.median(times) * 1e3, "profiled_wall_s": wall,
        "device_busy_s": busy_us / 1e6, "steps": PROFILED_STEPS,
        "groups_ms_per_step": {k: v[0] / 1e3 / PROFILED_STEPS for k, v in groups.items()},
        "phases": phases, "top": table,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
