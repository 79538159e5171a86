"""Command-line interface: `python -m ray_tpu_torch <command>`.

Port of `ray_tpu/cli.py`: every subcommand of the JAX CLI. Commands that
need a live cluster start a runtime in this process (or join one as an
observer with `--address`), act and report; a runtime that was already up
in the calling process is left running. The top-level `--no-cuda` (JAX's
`--no-tpu`) skips CUDA detection; without it, a command that starts its own
runtime (`doctor`, `status`, `postmortem`, `profile`, `dashboard`) raises
when there is no CUDA device.

`start` runs a cluster head (`start --head [--port P]`) or joins one as a
node agent (`start --address host:port`), with `--num-cpus`,
`--num-gpus`, `--resources`, `--labels` and `--token`. A node's `GPU`
resource is `torch.cuda.device_count()` unless `--num-gpus` says
otherwise. The process blocks until SIGTERM, SIGINT or a `shutdown_node`
RPC, then leaves the cluster gracefully (its node entry deregistered).
SIGTERM is a preemption notice, as in JAX: the node announces PREEMPTING,
drains for `preempt_warning_s` and then leaves gracefully
(`health.install_preemption_signal_handler`); a second SIGTERM changes
nothing. `--snapshot-path P` makes the head persist its GCS tables
(snapshots at P, the WAL at P.wal); `--restore` (with `--head`) requires
one of them and brings the head back from it on the same port, so
surviving agents re-register. `--launch-tag` only marks the command line,
so the launcher's `down` can find this cluster's processes.

`doctor` reports python's, torch's and CUDA's versions and each CUDA
device's name, then makes one task round trip. `job submit ENTRYPOINT
[--job-id ID] [--wait]`, `job status|logs|stop ID`, `job list` and `job
wait ID` drive this process's job manager (`jobs.py`); `up CONFIG
[--no-cuda]` and `down CONFIG` launch and tear down a cluster from a YAML
or JSON config (`launcher.py`). `config`, `status`, `logs`, `events`,
`request`, `steps`, `postmortem`, `timeline`, `profile` and `dashboard`
read the state API (`util/state.py`) as JAX's do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _no_cuda(args) -> bool:
    return bool(args.no_cuda_all or getattr(args, "no_cuda", False))


def _local_init(args) -> bool:
    """Start a runtime in this process (its CUDA devices as `GPU` unless
    --no-cuda, which a missing card requires); returns whether this call
    started it, so the command shuts down only what it started."""
    import torch

    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        return False
    if not _no_cuda(args) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --no-cuda to run without one")
    ray_tpu_torch.init(detect_accelerators=not _no_cuda(args))
    return True


def _observer_init(args) -> bool:
    """Join the cluster at --address as an observer node (no CPUs);
    returns whether this call started the runtime."""
    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        return False
    ray_tpu_torch.init(num_cpus=0, detect_accelerators=not _no_cuda(args),
                       address=args.address, cluster_token=args.token)
    time.sleep(1.0)  # let the cluster view and the node table populate
    return True


def _init_for(args) -> bool:
    """--address joins as an observer; otherwise a local runtime."""
    return _observer_init(args) if args.address else _local_init(args)


def _shutdown_if(owned: bool) -> None:
    if owned:
        import ray_tpu_torch

        ray_tpu_torch.shutdown()


def _cmd_doctor(args) -> int:
    """Environment sanity: python, torch and CUDA, the devices, one task."""
    import torch

    import ray_tpu_torch

    print(f"python: {sys.version.split()[0]}")
    print(f"torch: {torch.__version__}")
    print(f"cuda: {torch.version.cuda} (available: {torch.cuda.is_available()})")
    for i in range(torch.cuda.device_count()):
        print(f"device: cuda:{i} ({torch.cuda.get_device_name(i)})")
    owned = _local_init(args)
    print(f"cluster resources: {ray_tpu_torch.cluster_resources()}")

    @ray_tpu_torch.remote
    def probe():
        return "ok"

    if ray_tpu_torch.get(probe.remote(), timeout=60) != "ok":
        raise RuntimeError("the doctor's task round trip returned the wrong value")
    print("task round-trip: ok")
    _shutdown_if(owned)
    return 0


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


def _cmd_config(args) -> int:
    from .core.config import cfg

    print(cfg.describe())
    return 0


def _cmd_status(args) -> int:
    """Autoscaler-style cluster debug summary (reference `ray status`):
    per-node resources/usage/telemetry, pending demand, actors, PG
    states, object-store totals, recent warnings. --address joins an
    existing cluster as an observer; otherwise an in-process runtime is
    inspected. --json emits the machine shape instead."""
    from .util import state

    owned = _init_for(args)
    try:
        if args.autoscaler:
            # capacity-plane view only: managed nodes by type/class, pending
            # demand by origin, scale/replace/blocked counters
            scaler = state.autoscaler_summary()
            print(json.dumps(scaler if scaler is not None
                             else {"autoscaler": "not running"},
                             indent=2, default=str))
        elif args.json:
            print(json.dumps(state.summary(), indent=2, default=str))
        else:
            print(state.status_report(verbose=args.verbose))
    finally:
        _shutdown_if(owned)
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

    info = up_from_cli(args.config, no_cuda=_no_cuda(args))
    print(f"cluster up: {len(info['nodes'])} nodes, head at {info['address']}")
    print(f"connect with: ray_tpu_torch.init(address={info['address']!r})")
    return 0


def _cmd_down(args) -> int:
    from .launcher import down_from_cli

    print(f"stopped {down_from_cli(args.config)} nodes")
    return 0


def _cmd_logs(args) -> int:
    """Aggregate log tails across the cluster (reference: `ray logs`
    routed through the per-node dashboard agents)."""
    from .util import state

    owned = _observer_init(args)
    try:
        for node_hex, lines in state.cluster_logs(tail=args.tail).items():
            print(f"=== node {node_hex[:12]} ===")
            for line in lines:
                print(line)
            print()
    finally:
        _shutdown_if(owned)
    return 0


def _fmt_event(e) -> str:
    ts = time.strftime("%H:%M:%S", time.localtime(e.get("ts", 0)))
    node = str(e.get("node") or "-")[:8]
    kind = e.get("kind") or "-"
    extra = f" {e['extra']}" if e.get("extra") else ""
    return (f"{ts} {e['severity']:7s} {node:8s} {kind:22s} "
            f"[{e['source']}] {e['message']}{extra}")


def _cmd_events(args) -> int:
    """The cluster-wide flight-recorder tail (merged + sorted by wall
    time), filterable by --kind/--node/--severity/--since; --follow
    keeps polling for new events until interrupted."""
    from .util import state

    owned = _observer_init(args)
    filters = dict(kind=args.kind, node=args.node, severity=args.severity)
    cursor = float(args.since or 0.0)
    try:
        while True:
            evs = state.events(limit=args.limit, since=cursor, **filters)
            # strictly-after cursor: events() is >=, so skip the boundary
            evs = [e for e in evs if e.get("ts", 0.0) > cursor or cursor == 0.0]
            for e in evs:
                print(_fmt_event(e), flush=True)
            if evs:
                cursor = max(e.get("ts", 0.0) for e in evs)
            if not args.follow:
                break
            time.sleep(args.poll)
    except KeyboardInterrupt:
        pass
    finally:
        _shutdown_if(owned)
    return 0


def _cmd_request(args) -> int:
    """Request forensics: `request <id>` renders the causally
    ordered phase waterfall of one request (cluster-wide marks joined on
    the shared request id); `request --list [--tenant t]
    [--slow]` prints the summary table the on-call triages from."""
    from .serve import reqlog
    from .util import state

    owned = _observer_init(args)
    try:
        if args.list or not args.request_id:
            rows = state.list_requests(
                tenant=args.tenant, slow_only=args.slow, limit=args.limit
            )
            if not rows:
                print("(no requests recorded)")
                return 0
            print(f"{'request_id':<22} {'tenant':<10} {'ttft_s':>8} "
                  f"{'marks':>5} {'last_phase':<21} terminal")
            for s in rows:
                ttft = s.get("ttft_s")
                ttft_txt = f"{ttft:.4f}" if ttft is not None else "-"
                print(f"{s['request_id']:<22} "
                      f"{str(s.get('tenant') or '-'):<10} "
                      f"{ttft_txt:>8} "
                      f"{s.get('marks', 0):>5} "
                      f"{s.get('last_phase', '-'):<21} "
                      f"{s.get('terminal') or '-'}")
            return 0
        marks = state.request_timeline(args.request_id)
        print(reqlog.render_waterfall(marks))
        return 0 if marks else 1
    finally:
        _shutdown_if(owned)


def _cmd_steps(args) -> int:
    """Training forensics: `steps <run>` renders the per-rank
    step-phase waterfall of one run's sampled steps (buckets sum to step
    wall time, skew footers name the straggler rank and its dominant
    bucket); `steps --list` prints the cluster-wide sampled-step
    table."""
    from .train import steplog
    from .util import state

    owned = _observer_init(args)
    try:
        if args.list or not args.run:
            rows = state.list_steps(run=args.run, limit=args.limit)
            if not rows:
                print("(no sampled steps recorded)")
                return 0
            print(f"{'run':<18} {'step':>7} {'rank':>4} {'wall_s':>9} "
                  f"dominant_bucket")
            for s in rows:
                buckets = s.get("buckets") or {}
                top = max(buckets, key=buckets.get) if buckets else "-"
                wall = s.get("wall_s")
                wall_txt = f"{wall:.4f}" if wall is not None else "-"
                print(f"{str(s.get('run', '-')):<18} "
                      f"{s.get('step', 0):>7} "
                      f"{s.get('rank', 0):>4} "
                      f"{wall_txt:>9} "
                      f"{top}")
            return 0
        summaries = state.step_timeline(args.run, rank=args.rank)
        print(steplog.render_waterfall(summaries))
        return 0 if summaries else 1
    finally:
        _shutdown_if(owned)


def _cmd_postmortem(args) -> int:
    """Snapshot events + spans + metrics + node stats + profile metas
    into one bundle archive with a reconstructed Perfetto episode
    timeline (util/postmortem)."""
    from .util import state

    owned = _init_for(args)
    try:
        _postmortem(args, state)
    finally:
        _shutdown_if(owned)
    return 0


def _postmortem(args, state) -> None:
    manifest = state.postmortem(args.output, note=args.note or "")
    counts = manifest["counts"]
    print(f"wrote {args.output}: {counts['events']} event(s), "
          f"{counts['spans']} span(s), {counts['nodes']} node(s), "
          f"{counts['profiles']} profile meta(s)")
    for name, meta in sorted(manifest["files"].items()):
        print(f"  {name}: {meta['bytes']} bytes sha256={meta['sha256'][:12]}")
    if manifest.get("errors"):
        print(f"  (degraded planes: {sorted(manifest['errors'])})")
    print("open the bundle's timeline.json in ui.perfetto.dev")


def _cmd_profile(args) -> int:
    """Coordinated cluster profile capture (reference: per-worker
    profiling behind `ray timeline`/the dashboard profiler buttons):
    fan a time-boxed device trace + host sampling profile out to the
    selected nodes, register the artifacts, optionally write them to
    --output, and print where everything landed."""
    from .util import state

    owned = _init_for(args)
    try:
        _profile(args, state)
    finally:
        _shutdown_if(owned)
    return 0


def _profile(args, state) -> None:
    nodes = args.nodes.split(",") if args.nodes else None
    record = state.profile(
        nodes=nodes, duration_s=args.duration,
        device=not args.no_device, host=not args.no_host,
    )
    print(f"profile {record['profile_id']}: {len(record['nodes'])} node(s), "
          f"{record['duration_s']:.1f}s, {record['total_bytes']} bytes")
    for node_hex, meta in sorted(record["nodes"].items()):
        status = meta.get("error") or (
            f"device={meta.get('device')} host={meta.get('host')}"
        )
        print(f"  node {node_hex[:12]}: {status}")
        for name in meta.get("artifact_names", ()):
            print(f"    {name}")
    if args.output:
        from .core.runtime import get_runtime

        runtime = get_runtime()
        written = 0
        for key, data in runtime.profiles.artifacts_for(
            record["profile_id"]
        ).items():
            dest = os.path.join(args.output, record["profile_id"], key)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:  # atomic-ok: export copy, not state
                f.write(data)
            written += 1
        print(f"wrote {written} artifact(s) under "
              f"{os.path.join(args.output, record['profile_id'])}")
    print("merge into a timeline with: python -m ray_tpu_torch timeline --profile-id "
          f"{record['profile_id']} (same session)")


def _cmd_timeline(args) -> int:
    import ray_tpu_torch
    from .util import state

    if not ray_tpu_torch.is_initialized():
        print("no live runtime in this process; timeline covers the "
              "current session only", file=sys.stderr)
        ray_tpu_torch.init(detect_accelerators=False)
    # span-based distributed trace (util/tracing): nested
    # submit→queue→dispatch→execute→result causality, stitched across
    # nodes. --trace is the historical opt-in; chrome_tracing_dump is a
    # deprecated alias of trace_dump now, so both paths export spans.
    # --profile-id merges a registered capture's device tracks in.
    state.trace_dump(args.output, trace_id=args.trace_id,
                     profile_id=args.profile_id)
    print(f"wrote {args.output} (open in chrome://tracing or Perfetto)")
    return 0


def _cmd_dashboard(args) -> int:
    from .dashboard import start_dashboard, stop_dashboard

    owned = _local_init(args)
    url = start_dashboard(port=args.port)
    print(f"dashboard live at {url} (ctrl-c to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0
    finally:
        stop_dashboard()
        _shutdown_if(owned)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ray_tpu_torch",
                                description="ray_tpu_torch cluster/runtime CLI")
    p.add_argument("--no-cuda", dest="no_cuda_all", action="store_true",
                   help="skip CUDA detection (required where there is no card)")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("doctor", help="check the torch / CUDA environment")
    sub.add_parser("config", help="print all config flags")
    sp = sub.add_parser(
        "status", help="cluster debug summary: nodes, usage, telemetry"
    )
    sp.add_argument("--address", help="head GCS address to join as observer")
    sp.add_argument("--token", default=None)
    sp.add_argument("--verbose", "-v", action="store_true",
                    help="also show per-node log tails")
    sp.add_argument("--json", action="store_true",
                    help="emit state.summary() JSON instead of the report")
    sp.add_argument("--autoscaler", action="store_true",
                    help="emit only the capacity-plane (autoscaler) "
                         "status as JSON")

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

    lp = sub.add_parser("logs", help="tail logs from every cluster node")
    lp.add_argument("--address", help="head GCS address to join as observer")
    lp.add_argument("--tail", type=int, default=50)
    lp.add_argument("--token", default=None)

    ep = sub.add_parser("events", help="typed cluster flight-recorder events")
    ep.add_argument("--address", help="head GCS address to join as observer")
    ep.add_argument("--limit", type=int, default=50)
    ep.add_argument("--token", default=None)
    ep.add_argument("--kind", default=None,
                    help="only events of this registered kind "
                         "(e.g. preempt.announced, ckpt.saved)")
    ep.add_argument("--node", default=None,
                    help="only events attributed to this node id hex prefix")
    ep.add_argument("--severity", default=None,
                    help="only events at this severity (case-insensitive)")
    ep.add_argument("--since", type=float, default=None,
                    help="only events with wall ts >= this epoch-seconds value")
    ep.add_argument("--follow", "-f", action="store_true",
                    help="keep polling and printing new events (ctrl-c stops)")
    ep.add_argument("--poll", type=float, default=1.0,
                    help="poll interval for --follow, seconds")

    rq = sub.add_parser(
        "request",
        help="per-request forensics: timeline waterfall or request list",
    )
    rq.add_argument("request_id", nargs="?", default=None,
                    help="request id to render (x-request-id / the "
                         "request_id echoed in responses); omit with "
                         "--list")
    rq.add_argument("--list", action="store_true",
                    help="list request summaries instead of one timeline")
    rq.add_argument("--tenant", default=None,
                    help="with --list: only this tenant's requests")
    rq.add_argument("--slow", action="store_true",
                    help="with --list: only SLO-violating or timed-out "
                         "requests")
    rq.add_argument("--limit", type=int, default=50)
    rq.add_argument("--address", help="head GCS address to join as observer")
    rq.add_argument("--token", default=None)

    st = sub.add_parser(
        "steps",
        help="training forensics: per-rank step waterfall or step list",
    )
    st.add_argument("run", nargs="?", default=None,
                    help="run name to render (RunConfig.name); omit with "
                         "--list")
    st.add_argument("--list", action="store_true",
                    help="list sampled-step summaries instead of one run's "
                         "waterfall")
    st.add_argument("--rank", type=int, default=None,
                    help="only this world rank's steps")
    st.add_argument("--limit", type=int, default=50)
    st.add_argument("--address", help="head GCS address to join as observer")
    st.add_argument("--token", default=None)

    pm = sub.add_parser(
        "postmortem", help="snapshot a causal postmortem bundle (.tgz)"
    )
    pm.add_argument("--output", default="postmortem.tgz",
                    help="bundle archive path")
    pm.add_argument("--note", default=None,
                    help="free-text note recorded in the bundle manifest")
    pm.add_argument("--address", help="head GCS address to join as observer")
    pm.add_argument("--token", default=None)

    tp = sub.add_parser("timeline", help="dump a chrome-trace of this session")
    tp.add_argument("output", nargs="?", default="timeline.json")
    tp.add_argument("--trace", action="store_true",
                    help="export runtime spans (distributed trace, nested "
                         "causality) instead of the legacy task timeline")
    tp.add_argument("--trace-id", default=None,
                    help="with --trace: export only this trace (stitched "
                         "cluster-wide)")
    tp.add_argument("--profile-id", default=None,
                    help="merge this registered capture's device-trace "
                         "events in as per-device tracks")

    pf = sub.add_parser(
        "profile", help="coordinated device/host profile capture"
    )
    pf.add_argument("--nodes", default=None,
                    help="comma-separated node id hex prefixes (default: "
                         "every alive node)")
    pf.add_argument("--duration", type=float, default=None,
                    help="capture window in seconds "
                         "(default: profile_default_duration_s)")
    pf.add_argument("--no-device", action="store_true",
                    help="skip the device trace (torch.profiler)")
    pf.add_argument("--no-host", action="store_true",
                    help="skip the host sampling profile")
    pf.add_argument("--output", default=None,
                    help="directory to write the captured artifacts into")
    pf.add_argument("--address", help="head GCS address to join as observer")
    pf.add_argument("--token", default=None)

    dp = sub.add_parser("dashboard", help="serve the cluster dashboard")
    dp.add_argument("--port", type=int, default=8265)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    handler = {
        "start": _cmd_start,
        "doctor": _cmd_doctor,
        "config": _cmd_config,
        "status": _cmd_status,
        "job": _cmd_job,
        "up": _cmd_up,
        "down": _cmd_down,
        "logs": _cmd_logs,
        "events": _cmd_events,
        "request": _cmd_request,
        "steps": _cmd_steps,
        "postmortem": _cmd_postmortem,
        "timeline": _cmd_timeline,
        "profile": _cmd_profile,
        "dashboard": _cmd_dashboard,
    }[args.command]
    return handler(args)


if __name__ == "__main__":
    raise SystemExit(main())
