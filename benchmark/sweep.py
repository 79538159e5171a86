#!/usr/bin/env python3
"""Find the knee of an open-loop serving cell: the highest arrival rate it
sustains without a growing backlog.

    python3 benchmark/sweep.py --workload <name> --rates 2,4,6,8 --seconds 30 [--seed n]

One process builds the cell's server once, then offers the cell's traffic
at each rate for `--seconds` (a fresh seed per rate, so a shared-prefix
mix starts each rate with a cold cache), waits for every request, and
prints a JSON line per rate: requests sent and failed, TTFT p50 / p95
over the rate's requests and over the first and last third of its
arrivals, TPOT p95, the engine's queue wait p95, output tokens per second
over the window, and how late the generator ran. A rate is sustained where
the last third's TTFT p95 stays within 1.5 x the first third's + 0.5 s.
The cell's rate is then set at about 0.8 of the highest sustained rate.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import readers, runner, spec  # noqa: E402
from benchmark.harness import traffic as traffic_mod  # noqa: E402
from benchmark.harness.serve import Serving  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    from ray_tpu_torch.serve import tenancy

    dev = torch.device("cuda:0")
    runner._build_kernels(dev)
    serving = Serving(cell.config, args.seed, dev)
    serving.warm_up()  # each rate's seed brings its own prompts: a cold cache
    print(json.dumps({"setup_s": time.perf_counter() - T_START, "card": runner.card_line(),
                      "capture_s": serving.engine.capture_s,
                      "memory_allocated": torch.cuda.memory_allocated(dev)}), flush=True)
    vocab = cell.config["model"]["vocab_size"]
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        params = dict(cell.traffic, rate_per_s=rate)
        schedule = traffic_mod.open_loop(params, args.seed + 1000 * (i + 1), args.seconds, vocab)
        serving.records, serving.late_s = [], []
        tenancy.drain_queue_wait_window()
        t0 = time.perf_counter()
        sender = serving.open_loop(schedule, t0)
        time.sleep(max(0.0, t0 + args.seconds - time.perf_counter()))
        t1 = time.perf_counter()
        sender.join()
        serving.wait_all(t1 + float(params.get("drain_s", 150)))
        run = runner.Run(cell=cell, setup_s=0.0, t0=t0, t1=t1, records=serving.records)
        recs = serving.records
        ttft = [readers.ttft_s(run, r) for r in recs]
        third = max(1, len(recs) // 3)
        qw = [w for ws in tenancy.drain_queue_wait_window().values() for w in ws]
        first, last = readers.p95(ttft[:third]), readers.p95(ttft[-third:])
        print(json.dumps({
            "rate": rate, "sent": len(recs), "failed": sum(1 for r in recs if not r.ok),
            "ttft_p50_s": float(np.percentile(ttft, 50)), "ttft_p95_s": readers.p95(ttft),
            "ttft_p95_first_third_s": first, "ttft_p95_last_third_s": last,
            "tpot_p95_ms": readers.p95(v for v in map(readers.tpot_ms, recs) if v is not None),
            "queue_wait_p95_ms": 1e3 * (readers.p95(qw) or 0.0),
            "output_tokens_per_s": readers.tokens_between(run, t0, t1) / (t1 - t0),
            "drain_s": max((r.last or t1) for r in recs) - t1,
            "late_max_s": max(serving.late_s, default=0.0),
            "sustained": bool(last <= 1.5 * first + 0.5),
            "stats": {k: v for k, v in serving.engine.stats().items()
                      if k.startswith(("passes.", "prefix_cache_hits", "mixed_ticks", "decode_blocks"))},
        }), flush=True)
    serving.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
