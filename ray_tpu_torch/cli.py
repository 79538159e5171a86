"""Command-line interface: `python -m ray_tpu_torch <command>`.

Port of `ray_tpu/cli.py`'s `start`, `job`, `up` and `down`: start a cluster head
(`start --head [--port P]`) or join one as a node agent (`start --address
host:port`), with `--num-cpus`, `--num-gpus`, `--resources`, `--labels`
and `--token`. A node's `GPU` resource is `torch.cuda.device_count()`
unless `--num-gpus` says otherwise. The process blocks until SIGTERM,
SIGINT or a `shutdown_node` RPC, then leaves the cluster gracefully (its
node entry deregistered). SIGTERM is a preemption notice, as in JAX: the
node announces PREEMPTING, drains for `preempt_warning_s` and then leaves
gracefully (`health.install_preemption_signal_handler`); a second SIGTERM
changes nothing. `--snapshot-path P` makes the head persist its GCS
tables (snapshots at P, the WAL at P.wal); `--restore` (with `--head`)
requires one of them and brings the head back from it on the same port,
so surviving agents re-register. `--launch-tag` only marks the command
line, so the launcher's `down` can find this cluster's processes.

`job submit ENTRYPOINT [--job-id ID] [--wait]`, `job status|logs|stop ID`,
`job list` and `job wait ID` drive this process's job manager (`jobs.py`);
`up CONFIG [--no-cuda]` and `down CONFIG` launch and tear down a cluster
from a YAML or JSON config (`launcher.py`). Every other subcommand of the
JAX CLI raises NotImplementedError naming ROADMAP A8.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

A8_ITEM = "ROADMAP A8 (libraries and surfaces: cli.py)"
OTHER_COMMANDS = ("doctor", "config", "status", "logs", "events", "request", "steps",
                  "postmortem", "timeline", "profile", "dashboard")


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
    if args.snapshot_path:
        from .core.config import cfg

        cfg.set(gcs_snapshot_path=args.snapshot_path)
    if args.restore:
        from .core.config import cfg

        path = cfg.gcs_snapshot_path
        if not args.head:
            print("--restore only applies to --head", file=sys.stderr)
            return 2
        if not path or not (os.path.exists(path) or os.path.exists(path + ".wal")):
            # the WAL alone is restorable: a head that died before its
            # first snapshot still replays every acknowledged write
            print(f"--restore: no snapshot or WAL at {path!r}", file=sys.stderr)
            return 2
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


def _cmd_job(args) -> int:
    from .jobs import default_job_manager

    mgr = default_job_manager()
    if args.job_cmd == "submit":
        jid = mgr.submit(args.entrypoint, job_id=args.job_id)
        print(f"submitted {jid}")
        if args.wait:
            status = mgr.wait(jid)
            print(mgr.logs(jid), end="")
            print(f"job {jid}: {status.value}")
            return 0 if status.value == "SUCCEEDED" else 1
        return 0
    if args.job_cmd == "list":
        for info in mgr.list():
            print(f"{info.job_id}  {info.status.value:9}  {info.entrypoint}")
        return 0
    if args.job_cmd == "logs":
        print(mgr.logs(args.job_id), end="")
        return 0
    if args.job_cmd == "status":
        print(mgr.status(args.job_id).value)
        return 0
    if args.job_cmd == "stop":
        print("stopped" if mgr.stop(args.job_id) else "not running")
        return 0
    if args.job_cmd == "wait":
        status = mgr.wait(args.job_id, timeout=args.timeout)
        print(status.value)
        return 0 if status.value == "SUCCEEDED" else 1
    raise SystemExit(f"unknown job command {args.job_cmd!r}")


def _cmd_up(args) -> int:
    """Launch a cluster from a config file (`launcher.py`)."""
    from .launcher import up_from_cli

    info = up_from_cli(args.config, no_cuda=args.no_cuda)
    print(f"cluster up: {len(info['nodes'])} nodes, head at {info['address']}")
    print(f"connect with: ray_tpu_torch.init(address={info['address']!r})")
    return 0


def _cmd_down(args) -> int:
    from .launcher import down_from_cli

    print(f"stopped {down_from_cli(args.config)} nodes")
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
    st.add_argument("--launch-tag", default=None,
                    help="opaque tag in the command line, so the launcher's "
                         "`down` can target this cluster only")
    st.add_argument("--snapshot-path", default=None,
                    help="GCS snapshot file: the head persists its tables "
                         "here (same as RAY_TPU_GCS_SNAPSHOT_PATH)")
    st.add_argument("--restore", action="store_true",
                    help="with --head: require + replay the snapshot at "
                         "--snapshot-path so surviving agents re-register")
    jp = sub.add_parser("job", help="submit and inspect jobs")
    jsub = jp.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("entrypoint")
    js.add_argument("--job-id")
    js.add_argument("--wait", action="store_true",
                    help="block until the job finishes; print its logs")
    jsub.add_parser("list")
    for name in ("logs", "status", "stop"):
        jsub.add_parser(name).add_argument("job_id")
    jw = jsub.add_parser("wait")
    jw.add_argument("job_id")
    jw.add_argument("--timeout", type=float, default=None)
    up = sub.add_parser("up", help="launch a cluster from a config file")
    up.add_argument("config", help="cluster YAML or JSON (see ray_tpu_torch/launcher.py)")
    up.add_argument("--no-cuda", action="store_true",
                    help="start every node with --num-gpus 0")
    dn = sub.add_parser("down", help="terminate a cluster started with `up`")
    dn.add_argument("config")
    for name in OTHER_COMMANDS:
        sp = sub.add_parser(name, help=f"JAX's `{name}` ({A8_ITEM}: raises)")
        sp.add_argument("rest", nargs=argparse.REMAINDER)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    handlers = {"start": _cmd_start, "job": _cmd_job, "up": _cmd_up, "down": _cmd_down}
    return handlers.get(args.command, _not_ported)(args)


if __name__ == "__main__":
    raise SystemExit(main())
