#!/usr/bin/env python3
"""Run one cell of the benchmark of `ray_tpu_torch` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The cell (`BENCHMARK.json`'s `workloads`) names a
configuration and a traffic mix; the run builds the port's server or
trainer on weights made from the seed, offers the mix for `--seconds`,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` a `breakdown`, and last
`checks`: every number compared with its limit, which also close standard
error. It exits with 2, printing no result, without the cards; with 3 if
JAX, its libraries or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the program at a fixed place inside the checkout (the
# port's nvcc builds already live in ray_tpu_torch/ops/_build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))
RUN_LIMIT_S = 345

import torch  # noqa: E402

from benchmark.harness import runner, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # a run ends within its time limit: one that hangs prints every
    # thread's stack and exits
    faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)
    cell = spec.load_cell(args.workload, ROOT)
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {need} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    print(f"benchmark: {cell.name} seed {args.seed} {args.seconds:g} s trace {args.trace} on "
          f"{runner.card_line()}, torch {torch.__version__} cuda {torch.version.cuda}",
          file=sys.stderr)
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda:0"), T_START)
    found = runner.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    numbers = result.pop("_numbers")
    checks = result.pop("checks")
    result["checks"] = checks  # last in the line
    print(f"benchmark: compared {json.dumps(numbers, sort_keys=True)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


def _finite(value):
    """The result with every non-finite number (a p95 over failed requests,
    a gap with no request to judge) as null: the line stays JSON."""
    if isinstance(value, dict):
        return {k: _finite(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_finite(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


if __name__ == "__main__":
    sys.exit(main())
