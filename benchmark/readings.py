#!/usr/bin/env python3
"""Read the numbers that decide `correct` over many seeds in one process,
to set each limit between the program's readings and the control's.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 --seconds 20 [--control-seeds 1,2,3]

For each seed: one whole run of the cell (fresh set-up from the seed, a
window of `--seconds` at the cell's own load, the check against the
reference), printing the numbers compared as a JSON line. On the seeds in
`--control-seeds` the run also reads the control: the reference computed
in fp8 in the program's place (serving: at the same prompts and served
tokens, the gap of the token the control puts first; training: the fp8
reference's loss, first gradient and change against the float32
reference's), under `control_*`. `--fault` plants one of
`harness/faults.py`'s faults underneath the timed path, to read what it
does to the numbers.
"""

import time

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import runner, spec  # noqa: E402
from benchmark.harness.faults import FAULTS  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="plant this fault underneath the timed path (harness/faults.py)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = runner.run_cell(cell, seed, args.seconds, False, torch.device("cuda:0"), t,
                              control=seed in controls,
                              patch=FAULTS[args.fault] if args.fault else None)
        print(json.dumps({"workload": cell.name, "seed": seed, "fault": args.fault,
                          "correct": res["correct"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "numbers": res["_numbers"], "metrics": res["metrics"],
                          "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                          "run_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
