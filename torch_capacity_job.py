#!/usr/bin/env python3
"""A job for a launched ray_tpu_torch cluster: join it and run the flash
forward kernel on a worker's card.

    python3 torch_capacity_job.py --address HOST:PORT [--token T] [--seed S] [--device D]

It joins the cluster as a node without CPUs or GPUs
(`ray_tpu_torch.init(address=...)`), waits until its view of the cluster
holds a GPU, runs one `num_gpus=1` task,
`torch_cluster_udfs.flash_fwd_check`, which builds inputs from the seed on
the worker's card, launches the kernel and holds it against its plain
version there, and prints one line, `capacity-job {json}`, with the task's
result. `chip_smoke.py`'s `capacity` phase submits it through
`jobs.JobManager` to a cluster that `launcher.ClusterLauncher` brought up,
and reads the line from the job's log. It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import time

import ray_tpu_torch
import torch_cluster_udfs as udfs

FLASH_SHAPE = (8, 12, 1024, 64)  # GPT-2 124M's training shape (B, heads, S, D)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--address", required=True)
    p.add_argument("--token", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cpu: the plain version, for a rehearsal")
    args = p.parse_args()
    ray_tpu_torch.init(address=args.address, cluster_token=args.token, num_cpus=0, num_gpus=0)
    try:
        # this node learns of the others from the head's view: wait for the
        # worker's GPU before asking for it (the task would fail fast)
        deadline = time.monotonic() + 60
        while ray_tpu_torch.cluster_resources().get("GPU", 0.0) < 1:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no GPU joined: {ray_tpu_torch.cluster_resources()}")
            time.sleep(0.1)
        task = ray_tpu_torch.remote(num_gpus=1)(udfs.flash_fwd_check)
        out = ray_tpu_torch.get(task.remote(args.seed, FLASH_SHAPE, device=args.device),
                                timeout=300)
    finally:
        ray_tpu_torch.shutdown()
    print("capacity-job " + json.dumps(out), flush=True)
    return 0 if out["finite"] and out["launches"] == (args.device == "cuda") else 1


if __name__ == "__main__":
    raise SystemExit(main())
