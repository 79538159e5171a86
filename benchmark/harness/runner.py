"""One run of one cell: set-up, the measured window, the metrics, the
check, and the result line.

`run_cell` drives the serving or the training side by the traffic's
kind, fills a `Run` with what the window produced, hands it to each
metric's reader (`benchmark/metrics/<name>.py`) and compares the timed
path's outputs with the reference (`check.py`). With `trace` the window
runs under the profiler and the per-layer metrics are read; without it,
the end-to-end ones.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import check
from . import traffic as traffic_mod
from .spec import Cell
from .trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")
# a --trace 1 run reads the last TRACE_S seconds of its window: serving
# runs some 100 000 kernels a second, and the profiler's stop and the read
# of its events take about 80 us an event
TRACE_S = 10.0


@dataclasses.dataclass
class Run:
    """What a metric's reader sees of a finished run (host perf_counter
    seconds unless named otherwise)."""

    cell: Cell
    setup_s: float
    t0: float = 0.0                      # the window, on the host clock
    t1: float = 0.0
    records: List[Any] = dataclasses.field(default_factory=list)   # serving requests
    queue_waits: List[float] = dataclasses.field(default_factory=list)
    late_s: List[float] = dataclasses.field(default_factory=list)
    steps: int = 0                        # training steps finished in the window
    tokens_per_step: int = 0
    input_wait_s: float = 0.0
    trace: Optional[Trace] = None
    device_name: str = ""

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the run must not load (JAX, its
    libraries, the JAX package), compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _build_kernels(device: torch.device) -> None:
    if device.type == "cuda":
        from ray_tpu_torch.ops import KERNELS
        from ray_tpu_torch.ops._build import build_all

        build_all(KERNELS)


def _hold(t0: float, seconds: float, trace: bool) -> Optional[Trace]:
    """Wait out the window [t0, t0 + seconds] on the calling thread; with
    `trace`, start the profiler `TRACE_S` before its end. The caller stops
    it once the engine has gone quiet (`_traced_tail`)."""
    tr = None
    if trace:
        time.sleep(max(0.0, t0 + seconds - TRACE_S - time.perf_counter()))
        tr = Trace().start()
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    return tr


def _traced_tail(tr: Optional[Trace], t1: float) -> Optional[Trace]:
    """Stop the profiler (no thread launches work any more) and read it up
    to the window's end."""
    if tr is None:
        return None
    return _logged(tr.stop(until=t1))


def _logged(tr: Optional[Trace]) -> Optional[Trace]:
    if tr is not None:
        print(f"benchmark: trace stop {tr.stop_s:.2f} s, read {tr.read_s:.2f} s, "
              f"{len(tr.device)} device ops, {len(tr.host)} host ops", file=sys.stderr)
    return tr


def run_serve(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
              t_start: float, control: bool = False,
              patch: Optional[Callable[[Any], None]] = None) -> Dict[str, Any]:
    from ray_tpu_torch.serve import tenancy

    from .serve import Serving

    _build_kernels(device)
    serving = Serving(cell.config, seed, device)
    if patch is not None:
        patch(serving)
    vocab = cell.config["model"]["vocab_size"]
    params = cell.traffic
    serving.warm_up(traffic_mod.prefixes(params, seed, vocab) if params.get("warm_prefixes") else [])
    run = Run(cell=cell, setup_s=0.0)
    schedule = (traffic_mod.open_loop(params, seed, seconds, vocab)
                if params["kind"] == "open_loop" else None)
    backlog = traffic_mod.Backlog(params, seed, vocab) if params["kind"] == "backlog" else None
    tenancy.drain_queue_wait_window()
    run.t0 = time.perf_counter()
    run.setup_s = run.t0 - t_start
    if schedule is not None:
        sender = serving.open_loop(schedule, run.t0)
    else:
        depth = int(params["depth_slots"]) * cell.config["engine"]["max_slots"]
        serving.backlog(backlog, depth, run.t0 + seconds)
    tr = _hold(run.t0, seconds, trace)
    run.t1 = time.perf_counter()
    if schedule is not None:
        sender.join()
        serving.wait_all(run.t1 + float(params.get("drain_s", 150)))
    else:
        serving.engine.shutdown()  # the backlog's open requests are abandoned
    run.trace = _traced_tail(tr, run.t1)  # the engine is quiet now
    run.queue_waits = [w for ws in tenancy.drain_queue_wait_window().values() for w in ws]
    run.records = serving.records
    run.late_s = serving.late_s
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    serving.close()
    _free(device)
    sample = check.sample_requests(run.records, seed, int(params["check"]["sample_tokens"]),
                                   int(params["check"].get("sample_requests", 1)))
    numbers = (check.serve_numbers(serving.weights, cell.config["model"], sample, control)
               if sample else {"max_logit_gap": float("inf")})
    sent = [r for r in run.records if not r.abandoned]
    return {"run": run, "numbers": numbers, "memory_peak_bytes": int(peak),
            "attempted": len(sent), "failed": sum(1 for r in sent if not r.ok)}


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
              t_start: float, control: bool = False,
              patch: Optional[Callable[[Any], None]] = None) -> Dict[str, Any]:
    from .train import Training

    _build_kernels(device)
    training = Training(cell.config, cell.traffic, seed, device)
    if patch is not None:
        patch(training)
    training.first_steps(int(cell.traffic["first_steps"]))
    run = Run(cell=cell, setup_s=0.0, tokens_per_step=training.tokens_per_step)
    run.setup_s = time.perf_counter() - t_start
    w = training.window(seconds, TRACE_S if trace else 0.0)
    run.trace = _logged(w["trace"])
    run.t0, run.t1, run.steps, run.input_wait_s = w["t0"], w["t1"], w["steps"], w["input_wait_s"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    program = {"loss": training.losses, "grad_norm": training.grad_norm,
               "change_norm": training.change_norm}
    batches = list(training.feed.kept)
    training.close()
    del training
    _free(device)
    reference = check.train_reference(cell.config, seed, batches, device)
    numbers = check.train_numbers(program, reference)
    if control:
        _free(device)
        fp8 = check.train_reference(cell.config, seed, batches, device, precision="fp8")
        numbers.update({f"control_{k}": v for k, v in check.train_numbers(fp8, reference).items()})
    return {"run": run, "numbers": numbers, "memory_peak_bytes": int(peak),
            "attempted": run.steps + len(batches), "failed": 0}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, control: bool = False,
             patch: Optional[Callable[[Any], None]] = None) -> Dict[str, Any]:
    """One run; returns the result line's fields plus `numbers` (every
    number compared) and `limits`."""
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    side = run_serve if cell.kind == "serve" else run_train
    out = side(cell, seed, seconds, trace, device, t_start, control, patch)
    run: Run = out["run"]
    run.device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    metrics: Dict[str, Any] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    limits = {k: float(v) for k, v in cell.config["check"]["limits"].items()}
    numbers = out["numbers"]
    correct = check.verdict(numbers, limits) and all(np.isfinite(numbers[k]) for k in limits)
    result: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": run.device_name, "count": int(cell.entry["chips"]),
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["generator_late_s"] = {"max": max(run.late_s, default=0.0),
                                  "p95": float(np.percentile(run.late_s, 95)) if run.late_s else 0.0}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result["_numbers"] = numbers
    return result
