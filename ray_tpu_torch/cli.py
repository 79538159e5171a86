"""Command-line interface: `python -m ray_tpu_torch <command>`.

Port of `ray_tpu/cli.py`'s `start`: start a cluster head
(`start --head [--port P]`) or join one as a node agent (`start --address
host:port`), with `--num-cpus`, `--num-gpus`, `--resources`, `--labels`
and `--token`. A node's `GPU` resource is `torch.cuda.device_count()`
unless `--num-gpus` says otherwise. The process blocks until SIGTERM,
SIGINT or a `shutdown_node` RPC, then leaves the cluster gracefully (its
node entry deregistered). SIGTERM is a preemption notice, as in JAX: the
node announces PREEMPTING, drains for `preempt_warning_s` and then leaves
gracefully (`health.install_preemption_signal_handler`); a second SIGTERM
changes nothing. `--snapshot-path` and `--restore` come with ROADMAP A6b
(head restart). Every other
subcommand of the JAX CLI raises NotImplementedError naming ROADMAP A8.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

A8_ITEM = "ROADMAP A8 (libraries and surfaces: cli.py)"
OTHER_COMMANDS = ("doctor", "config", "status", "job", "up", "down", "logs", "events",
                  "request", "steps", "postmortem", "timeline", "profile", "dashboard")


def _process_age_s() -> float:
    """Seconds since this process started (/proc), or 0.0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _cmd_start(args) -> int:
    """Start a cluster head or join a cluster as a node agent, and serve
    until asked to stop."""
    import ray_tpu_torch

    imported_s = _process_age_s()  # the interpreter and the package's imports
    t0 = time.monotonic()

    if bool(args.head) == bool(args.address):
        print("pass exactly one of --head or --address", file=sys.stderr)
        return 2
    if args.snapshot_path or args.restore:
        raise NotImplementedError(
            "--snapshot-path / --restore (GCS snapshots and a restored head) are not "
            "ported to ray_tpu_torch yet: ROADMAP A6b (head restart)")
    rt = ray_tpu_torch.init(
        num_cpus=args.num_cpus,
        # None: the detected CUDA devices (torch.cuda.device_count())
        num_gpus=args.num_gpus,
        resources=json.loads(args.resources) if args.resources else None,
        labels=json.loads(args.labels) if args.labels else None,
        head=args.head,
        address=args.address,
        cluster_token=args.token,
        gcs_port=args.port,
    )
    ctx = rt.cluster
    if args.head:
        print(f"head up: gcs at {ctx.gcs_address}, node agent at {ctx.address}", flush=True)
        print(f"join with: python -m ray_tpu_torch start --address {ctx.gcs_address}",
              flush=True)
    else:
        print(f"node {ctx.node_id.hex()[:12]} joined {args.address}, agent at {ctx.address} "
              f"({imported_s:.2f} s to start and import, {time.monotonic() - t0:.2f} s to "
              f"init and join)", flush=True)
    # SIGTERM = an announced preemption: announce and drain for the
    # warning window, then leave gracefully
    from .core.health import install_preemption_signal_handler

    install_preemption_signal_handler(ctx)
    try:
        while not ctx.shutdown_requested.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    ray_tpu_torch.shutdown()
    return 0


def _not_ported(args) -> int:
    raise NotImplementedError(
        f"`python -m ray_tpu_torch {args.command}` is not ported to ray_tpu_torch yet: "
        f"{A8_ITEM}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ray_tpu_torch",
                                description="ray_tpu_torch cluster command line")
    sub = p.add_subparsers(dest="command", required=True)
    st = sub.add_parser("start", help="start a cluster head or join one")
    st.add_argument("--head", action="store_true",
                    help="serve the GCS and become the head node")
    st.add_argument("--address", help="head GCS address (host:port) to join")
    st.add_argument("--port", type=int, default=0,
                    help="GCS port for --head (0 = ephemeral)")
    st.add_argument("--num-cpus", type=int, default=None)
    st.add_argument("--num-gpus", type=int, default=None,
                    help="GPU resource of this node (default: torch.cuda.device_count())")
    st.add_argument("--resources", default=None,
                    help='extra custom resources as JSON, e.g. \'{"accel": 2}\'')
    st.add_argument("--labels", default=None,
                    help='node labels as JSON, e.g. \'{"zone": "us-a"}\'')
    st.add_argument("--token", default=None,
                    help="cluster auth token (required off-localhost)")
    st.add_argument("--snapshot-path", default=None,
                    help="GCS snapshot file (ROADMAP A6b: raises)")
    st.add_argument("--restore", action="store_true",
                    help="replay the snapshot at --snapshot-path (ROADMAP A6b: raises)")
    for name in OTHER_COMMANDS:
        sp = sub.add_parser(name, help=f"JAX's `{name}` ({A8_ITEM}: raises)")
        sp.add_argument("rest", nargs=argparse.REMAINDER)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return (_cmd_start if args.command == "start" else _not_ported)(args)


if __name__ == "__main__":
    raise SystemExit(main())
