"""The port's federation (`ray_tpu_torch/core/cluster.py`'s stats
piggyback, the `_events` / `_requests` / `_steps` tables and the node
fan-out; `core/stats.py`; `util/state.py`, `util/metrics.py`,
`util/logs.py`): the federation cases of `tests/test_observability.py`,
`tests/test_flight_recorder.py`, `tests/test_reqlog.py` and
`tests/test_steplog.py` run on the port, each single-head case beside
the same program on JAX's head runtime (both live in one process: two
packages, two globals) with the answers compared; the stats snapshot's
keys against JAX's collector's; and a shared cluster (a head here, one
node agent) where an agent's marks, metrics, logs, events, spans and a
profile capture reach this process.
"""

import os
import time

import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.cluster import NODE_NS
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.gcs import EVENT_NS, REQLOG_NS, STEPLOG_NS
from ray_tpu_torch.core.scheduler import NodeAffinitySchedulingStrategy
from ray_tpu_torch.serve import reqlog
from ray_tpu_torch.train import steplog
from ray_tpu_torch.util import state
from ray_tpu_torch.util.events import events


_LAG_KEY = {EVENT_NS: "events", REQLOG_NS: "requests", STEPLOG_NS: "steps"}


def _drain(ctx, namespace):
    """Force federation passes (normally on the stats piggyback) until the
    cursor has caught up with the ring: the process-global logs may hold a
    backlog from earlier tests larger than one bounded batch, or than the
    table's cap. Returns the table's tail."""
    key = _LAG_KEY.get(namespace)
    for _ in range(1000):
        ctx._last_stats_ts = 0.0
        ctx._report_stats()
        if not ctx._federation_lag().get(key, 0):
            break
    return ctx.gcs.kv_get(ctx.node_id.hex(), namespace=namespace) or []


def _one_pass(ctx):
    ctx._last_stats_ts = 0.0
    ctx._report_stats()


def _step_record(run, rank, step, *, data_wait=0.002, fwd_bwd=0.01):
    """A hand-built sampled-step record shaped like the trainer's
    `_steplog` payload entries (JAX's test helper)."""
    buckets = {"data_wait": data_wait, "h2d": 0.001, "fwd_bwd_compute": fwd_bwd,
               "dp_sync": 0.0, "optimizer_update": 0.0, "ckpt_save": 0.0,
               "report": 0.001, "other": 0.0005}
    return {"run": run, "rank": rank, "step": step, "node": None, "ts": time.time(),
            "wall_s": sum(buckets.values()), "buckets": buckets}


def _jax_head():
    import ray_tpu

    return ray_tpu.init(num_cpus=1, head=True, detect_accelerators=False)


def _jax_shutdown():
    import ray_tpu
    from ray_tpu.core.config import cfg as jcfg

    jcfg.reset()
    ray_tpu.shutdown()


# ------------------------------------------------- one head, port and JAX


def test_events_federate_into_gcs_table_and_state_query():
    """Events ship into `_events` with node attribution, the cursor
    advances, and `state.events()` merges, filters and dedupes: the port's
    answers equal JAX's on the same emits."""
    from ray_tpu.core.gcs import EVENT_NS as JEVENT_NS
    from ray_tpu.util import state as jstate
    from ray_tpu.util.events import events as jevents

    def drive(init, emit_log, st, ns, shutdown):
        rt = init()
        try:
            ctx = rt.cluster
            my_hex = ctx.node_id.hex()
            emit_log().emit("WARNING", "test", "flight recorder drill",
                            kind="chaos.injected", mode="drill")
            tail = _drain(ctx, ns)
            assert tail, "no events federated into the _events table"
            assert any(e.get("kind") == "chaos.injected" for e in tail)
            assert all(e.get("node") for e in tail)
            before = len(tail)
            _one_pass(ctx)
            assert len(ctx.gcs.kv_get(my_hex, namespace=ns)) == before
            drill = st.events(kind="chaos.injected")
            keys = [(e.get("node"), e.get("seq")) for e in drill]
            assert len(keys) == len(set(keys)), "duplicate (node, seq) entries"
            return dict(
                last=(drill[-1]["message"], drill[-1]["kind"], drill[-1]["severity"]),
                by_node=bool(st.events(kind="chaos.injected", node=my_hex[:8])),
                future=st.events(kind="chaos.injected", since=time.time() + 60),
                by_severity=bool(st.events(kind="chaos.injected", severity="warning")),
            )
        finally:
            shutdown()

    want = drive(_jax_head, jevents, jstate, JEVENT_NS, _jax_shutdown)
    got = drive(lambda: ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False),
                events, state, EVENT_NS, ray_tpu_torch.shutdown)
    assert got == want
    assert got["last"] == ("flight recorder drill", "chaos.injected", "WARNING")


def test_events_table_is_bounded():
    """The `_events` table keeps the newest `events_table_cap` per node."""
    rt = ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False)
    cfg.set(events_table_cap=20, events_federate_batch=500)
    try:
        ctx = rt.cluster
        for i in range(80):
            events().emit("INFO", "test", f"burst {i}", kind="node.discovered")
        tail = _drain(ctx, EVENT_NS)
        assert len(tail) <= 20
        assert tail[-1]["message"] == "burst 79"  # the newest survive
    finally:
        cfg.reset()
        ray_tpu_torch.shutdown()


def test_request_marks_federate_and_state_queries():
    """Request marks ship into `_requests`; `request_timeline`,
    `list_requests` (tenant, slow_only) join the ring and the table with
    dedup; the recorder's off-switch ships nothing new. The port's
    answers equal JAX's on the same marks."""
    from ray_tpu.core.config import cfg as jcfg
    from ray_tpu.core.gcs import REQLOG_NS as JREQLOG_NS
    from ray_tpu.serve import reqlog as jreqlog
    from ray_tpu.util import state as jstate

    def drive(init, rl, st, ns, c, shutdown):
        rt = init()
        try:
            ctx = rt.cluster
            my_hex = ctx.node_id.hex()
            rl.mark("req-fed", "route.received", tenant="fed")
            rl.mark("req-fed", "engine.first_token", tenant="fed", ttft_s=9.0,
                    queue_wait_s=8.0, preempt_wait_s=0.0, prefill_compute_s=1.0)
            rl.mark("req-fed", "engine.finished", tenant="fed")
            rl.mark("req-other", "route.shed", reason="parked_queue_full")
            tail = _drain(ctx, ns)
            assert tail and all(m.get("node") for m in tail)
            before = len(tail)
            _one_pass(ctx)
            assert len(ctx.gcs.kv_get(my_hex, namespace=ns)) == before
            tl = st.request_timeline("req-fed")
            keys = [(m.get("node"), m.get("seq")) for m in tl]
            assert len(keys) == len(set(keys)), "duplicate (node, seq)"
            rows = {s["request_id"]: s for s in st.list_requests()}
            out = dict(
                phases=[m["phase"] for m in tl],
                terminals=(rows["req-fed"]["terminal"], rows["req-other"]["terminal"]),
                tenant=[s["request_id"] for s in st.list_requests(tenant="fed")],
                slow=any(s["request_id"] == "req-fed" for s in st.list_requests(slow_only=True)),
            )
            c.set(serve_request_log=False)
            rl.log().mark("req-dark", "route.received")
            _one_pass(ctx)
            out["dark"] = any(m["rid"] == "req-dark"
                              for m in ctx.gcs.kv_get(my_hex, namespace=ns))
            return out
        finally:
            c.reset()
            shutdown()

    want = drive(_jax_head, jreqlog, jstate, JREQLOG_NS, jcfg, _jax_shutdown)
    got = drive(lambda: ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False),
                reqlog, state, REQLOG_NS, cfg, ray_tpu_torch.shutdown)
    assert got == want
    assert got["phases"] == ["route.received", "engine.first_token", "engine.finished"]
    assert got["terminals"] == ("engine.finished", "route.shed") and got["slow"]
    assert got["dark"] is False


def test_reqlog_table_is_bounded():
    """The `_requests` table keeps the newest `reqlog_table_cap` per node."""
    rt = ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False)
    cfg.set(reqlog_table_cap=20, reqlog_federate_batch=500)
    try:
        ctx = rt.cluster
        for i in range(80):
            reqlog.mark(f"req-burst-{i}", "engine.submitted")
        tail = _drain(ctx, REQLOG_NS)
        assert len(tail) <= 20
        assert tail[-1]["rid"] == "req-burst-79"
    finally:
        cfg.reset()
        ray_tpu_torch.shutdown()


def test_step_marks_federate_and_state_queries():
    """Step marks ship into `_steps`; `step_timeline`, `list_steps` and
    `step_skew` join the ring and the table with the semantic dedup; the
    lag drains to 0; the off-switch ships nothing new. The port's answers
    equal JAX's on the same records."""
    from ray_tpu.core.config import cfg as jcfg
    from ray_tpu.core.gcs import STEPLOG_NS as JSTEPLOG_NS
    from ray_tpu.train import steplog as jsteplog
    from ray_tpu.util import state as jstate

    def drive(init, sl, st, ns, c, shutdown):
        rt = init()
        try:
            ctx = rt.cluster
            my_hex = ctx.node_id.hex()
            sl.log().ingest([_step_record("fed-run", 0, 1, data_wait=0.002),
                             _step_record("fed-run", 1, 1, data_wait=0.300),
                             _step_record("other-run", 0, 7)])
            tail = _drain(ctx, ns)
            assert tail and all(m.get("node") for m in tail)
            before = len(tail)
            _one_pass(ctx)
            assert len(ctx.gcs.kv_get(my_hex, namespace=ns)) == before
            summaries = st.step_timeline("fed-run")
            for s in summaries:
                assert s["sealed"]
                assert sum(s["buckets"].values()) == pytest.approx(s["wall_s"])
            skew = st.step_skew("fed-run")
            out = dict(
                summaries=[(s["rank"], s["step"], s["buckets"]) for s in summaries],
                runs=sorted({s["run"] for s in st.list_steps()} & {"fed-run", "other-run"}),
                other=[s["run"] for s in st.list_steps(run="other-run")],
                skew=(skew[0]["straggler_rank"], skew[0]["dominant_bucket"]),
                lag=ctx._federation_lag().get("steps", 0),
            )
            c.set(train_step_log=False)
            sl.log().mark("data_wait", 0.1, run="dark-fed", rank=0, step=1)
            _one_pass(ctx)
            out["dark"] = any(m["run"] == "dark-fed"
                              for m in ctx.gcs.kv_get(my_hex, namespace=ns))
            return out
        finally:
            c.reset()
            shutdown()

    want = drive(_jax_head, jsteplog, jstate, JSTEPLOG_NS, jcfg, _jax_shutdown)
    got = drive(lambda: ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False),
                steplog, state, STEPLOG_NS, cfg, ray_tpu_torch.shutdown)
    assert got == want
    assert [(r, s) for r, s, _ in got["summaries"]] == [(0, 1), (1, 1)]
    assert got["skew"] == (1, "data_wait") and got["lag"] == 0 and got["dark"] is False


def test_steplog_table_is_bounded():
    """The `_steps` table keeps the newest `steplog_table_cap` per node."""
    rt = ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False)
    cfg.set(steplog_table_cap=20, steplog_federate_batch=500)
    try:
        ctx = rt.cluster
        for i in range(80):
            steplog.mark("data_wait", 0.01, run="burst", rank=0, step=i)
        tail = _drain(ctx, STEPLOG_NS)
        assert len(tail) <= 20
        assert tail[-1]["step"] == 79
    finally:
        cfg.reset()
        ray_tpu_torch.shutdown()


def test_reconnect_flush_drops_what_already_landed():
    """A put that landed at the head but whose reply was lost leaves the
    cursor behind: the next flush re-ships the batch and the table drops
    the marks it already holds, by seq, so each mark lands once."""
    rt = ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False)
    try:
        ctx = rt.cluster
        start = reqlog.log().stats()["seq"]
        for i in range(5):
            reqlog.mark("req-twice", "engine.submitted", n=i)
        tail = _drain(ctx, REQLOG_NS)
        ctx._reqlog_cursor = start  # as if the replies of these marks' puts were lost
        _one_pass(ctx)
        again = ctx.gcs.kv_get(ctx.node_id.hex(), namespace=REQLOG_NS)
        assert [m["seq"] for m in again] == [m["seq"] for m in tail]
        assert len(state.request_timeline("req-twice")) == 5
        assert ctx._federation_lag()["requests"] == 0
    finally:
        ray_tpu_torch.shutdown()


def test_stats_snapshot_keys_match_jax():
    """The port's stats snapshot has JAX's keys, its TPU block (`tpu`)
    replaced by the CUDA block (`cuda`), with the same nested keys where
    the planes are the same; on the CPU the CUDA block is empty and no
    CUDA context exists."""
    import torch

    import ray_tpu

    jrt = ray_tpu.init(num_cpus=1, head=True, detect_accelerators=False)
    try:
        want = jrt.node_stats.snapshot()
    finally:
        _jax_shutdown()
    rt = ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False)
    try:
        got = rt.node_stats.snapshot()
    finally:
        ray_tpu_torch.shutdown()
    assert set(got) == (set(want) - {"tpu"}) | {"cuda"}
    for key in ("worker_pool", "task_queues", "agent", "pubsub"):
        assert set(got[key]) == set(want[key]), key
    assert got["cuda"] == [] and not torch.cuda.is_initialized()
    assert got["pid"] == os.getpid() and got["rss_bytes"] > 0


# ----------------------------------------------- a shared cluster: one agent


@pytest.fixture(scope="class")
def fed():
    """A head in this process + one node agent, both heartbeating and
    piggybacking stats every 0.2 s."""
    before = torch_process_udfs.live_children()
    sysconf = {"node_heartbeat_s": 0.2, "node_stats_period_s": 0.2}
    c = Cluster(head_node_args={"num_cpus": 2, "_system_config": {"node_stale_s": 5.0,
                                                                   **sysconf}})
    try:
        c.add_node(num_cpus=2, num_gpus=0, system_config=sysconf)
        c.wait_for_nodes(2)
        yield c
    finally:
        c.shutdown()
        cfg.reset()
        assert torch_process_udfs.wait_no_children(before) == [], "an agent outlived its cluster"


def _agent(c):
    return next(n for n in c.runtime.scheduler.nodes() if n.is_remote)


def _on(node):
    return NodeAffinitySchedulingStrategy(node.node_id)


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while True:
        value = pred()
        if value:
            return value
        assert time.monotonic() < deadline, "condition never became true"
        time.sleep(0.1)


class TestFederatedCluster:
    def test_cluster_telemetry_roundtrip_and_federation(self, fed):
        """Stats snapshots round-trip through the GCS node table on the
        heartbeat, `state.node_stats()` / `summary()` carry both, and the
        head federates both nodes' expositions with node_id labels (TYPE
        headers once)."""
        ctx = fed.runtime.cluster

        def table():
            t = {k: ctx.gcs.kv_get(k, namespace=NODE_NS) for k in ctx.gcs.kv_keys(namespace=NODE_NS)}
            return t if len(t) == 2 and all((i or {}).get("stats") for i in t.values()) else None

        t = _wait(table)
        for info in t.values():
            stats = info["stats"]
            assert "object_store" in stats and "worker_pool" in stats and "cuda" in stats
            assert "task_queues" in stats and stats["rss_bytes"] > 0
            assert "federation_lag" in info
        ns = state.node_stats()
        assert set(ns) == set(t)
        assert state.summary()["node_stats"].keys() == ns.keys()
        merged = state.cluster_metrics()
        samples = [ln for ln in merged.strip().splitlines() if not ln.startswith("#")]
        assert samples and all('node_id="' in ln for ln in samples)
        for node_hex in t:
            assert f'node_id="{node_hex}"' in merged, node_hex[:12]
        assert merged.count("# TYPE raytpu_node_rss_bytes gauge") == 1
        raw = state.cluster_metrics(raw=True)
        assert set(raw) == set(t)
        assert "Nodes: 2" in state.status_report()

    def test_fanout_logs_events_and_a_placeholder(self, fed):
        """`fanout_nodes` reaches the agent; `cluster_logs` and
        `cluster_events` hold both nodes; a call the agent cannot answer
        fills the placeholder, naming the node, instead of dropping it."""
        ctx = fed.runtime.cluster
        agent_hex = _agent(fed).node_id.hex()
        info = ctx.fanout_nodes("node_info")
        assert info[agent_hex]["pid"] == fed._nodes[0].pid
        assert set(state.cluster_logs(20)) == {ctx.node_id.hex(), agent_hex}
        ev = state.cluster_events(50)
        assert set(ev) == {ctx.node_id.hex(), agent_hex}
        missing = ctx.fanout_nodes("no_such_method", placeholder=lambda e: f"unreachable: {e!r}")
        assert set(missing) == {agent_hex} and missing[agent_hex].startswith("unreachable")
        assert ctx.fanout_nodes("no_such_method") == {agent_hex: None}

    def test_agent_marks_reach_the_head_and_the_timelines(self, fed):
        """Request and step marks recorded on the agent ship into the head's
        tables (attributed to the agent's node) and this process's
        `request_timeline` / `step_timeline` join them with its own marks;
        the agent's federation lag drains to 0 and `head_summary` says
        so."""
        ctx = fed.runtime.cluster
        agent = _agent(fed)
        agent_hex = agent.node_id.hex()
        reqlog.mark("req-x", "route.received", tenant="fed")
        on_agent = ray_tpu_torch.remote(num_cpus=1)
        assert ray_tpu_torch.get(on_agent(udfs.mark_request).options(
            scheduling_strategy=_on(agent)).remote("req-x"), timeout=60) == fed._nodes[0].pid
        steplog.mark("data_wait", 0.002, run="fed-gang", rank=0, step=0)
        steplog.mark("fwd_bwd_compute", 0.01, run="fed-gang", rank=0, step=0)
        steplog.mark("other", 0.001, run="fed-gang", rank=0, step=0)
        ray_tpu_torch.get(on_agent(udfs.mark_steps).options(
            scheduling_strategy=_on(agent)).remote("fed-gang", 1), timeout=60)

        tl = _wait(lambda: (lambda t: t if len(t) == 4 else None)(state.request_timeline("req-x")))
        assert [m["phase"] for m in tl] == ["route.received", "engine.submitted",
                                            "engine.first_token", "engine.finished"]
        assert [m["node"] for m in tl[1:]] == [agent_hex] * 3
        assert tl[0]["node"] == ctx.node_id.hex()
        on_table = ctx.gcs.kv_get(agent_hex, namespace=REQLOG_NS)
        assert sorted(m["phase"] for m in on_table if m["rid"] == "req-x") == [
            "engine.finished", "engine.first_token", "engine.submitted"]
        steps = _wait(lambda: (lambda s: s if len(s) == 2 else None)(
            state.step_timeline("fed-gang")))
        assert [(s["rank"], s["step"]) for s in steps] == [(0, 0), (1, 0)]
        assert state.step_skew("fed-gang")[0]["straggler_rank"] == 1

        def drained():
            info = ctx.gcs.kv_get(agent_hex, namespace=NODE_NS) or {}
            lag = info.get("federation_lag") or {}
            return lag if lag and not any(lag.values()) else None

        assert _wait(drained)["events"] == 0
        summary = state.head_summary()
        assert summary["epoch"] == 0 and summary["head_outage_s"] == 0.0
        assert not any(summary.get("federation_lag", {}).get(agent_hex, {}).values())

    def test_fanout_capture_reaches_the_agent(self, fed):
        """`state.profile(nodes=[agent])` fans the capture out to the agent
        (on its RPC server's thread, as JAX's), returns the agent's trace and
        host profile in the record and registers it; the agent's spans
        stitch into `get_trace` and `trace_dump`."""
        agent = _agent(fed)
        agent_hex = agent.node_id.hex()
        busy = ray_tpu_torch.remote(num_cpus=1)(udfs.busy_matmuls).options(
            scheduling_strategy=_on(agent)).remote(1.5)
        record = state.profile(nodes=[agent_hex[:8]], duration_s=0.6)
        assert ray_tpu_torch.get(busy, timeout=60) > 0
        assert list(record["nodes"]) == [agent_hex]
        meta = record["nodes"][agent_hex]
        assert meta["device"] == "ok" and meta["host"] == "ok", meta
        assert meta["pid"] == fed._nodes[0].pid
        assert record["total_bytes"] > 0
        assert record["profile_id"] in [p["profile_id"] for p in state.list_profiles()]
        names = meta["artifact_names"]
        assert any(n.endswith(".trace.json.gz") for n in names), names
        assert len(state.profile_artifact(record["profile_id"], agent_hex, names[0])) > 0
        from ray_tpu_torch.util.tracing import tracer

        submit = [s for s in tracer().spans() if s["name"] == "task.submit"][-1]
        assert not any(s["name"] == "task.execute" for s in tracer().spans(submit["trace_id"]))
        spans = state.get_trace(submit["trace_id"])
        assert any(s["name"] == "task.execute" for s in spans), spans
        assert '"traceEvents"' in state.trace_dump()

    def test_a_capturing_node_stays_live_without_heartbeats(self, fed):
        """While the agent captures, its reports ask the head to keep it
        live for the window plus the profiler's hold
        (`ClusterContext.quiet`); its first heartbeat after the capture
        ends that."""
        import threading

        from ray_tpu_torch.util import profiling

        agent_hex = _agent(fed).node_id.hex()
        syncer = fed.runtime.cluster.gcs_server.syncer
        _wait(lambda: agent_hex not in syncer._quiet_until)  # an earlier capture's
        box = {}
        capture = threading.Thread(target=lambda: box.setdefault(
            "record", state.profile(nodes=[agent_hex[:8]], duration_s=1.0)))
        t0 = time.monotonic()
        capture.start()
        until = _wait(lambda: syncer._quiet_until.get(agent_hex))
        assert until - t0 > profiling.CAPTURE_HOLD_S
        capture.join(60)
        assert box["record"]["nodes"][agent_hex]["device"] == "ok"
        _wait(lambda: agent_hex not in syncer._quiet_until)
        assert agent_hex in syncer.cluster_view()["nodes"]


class _Clock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


def test_quiet_report_keeps_a_silent_node_in_the_view(monkeypatch):
    """A report with `quiet_s` keeps the node in the view past `stale_s`
    until the window closes; a plain report ends the window at once."""
    from ray_tpu_torch.core import gcs_service

    clock = _Clock()
    monkeypatch.setattr(gcs_service, "time", clock)
    sync = gcs_service._ResourceSync(stale_s=2.0)
    sync.report("quiet", {"CPU": 1.0}, quiet_s=10.0)
    sync.report("plain", {"CPU": 2.0})
    clock.now += 5.0
    assert set(sync.cluster_view()["nodes"]) == {"quiet"}
    assert sync.cluster_view()["total"] == {"CPU": 1.0}
    sync.report("quiet", {"CPU": 1.0})  # the capture is over
    clock.now += 2.5
    assert sync.cluster_view()["nodes"] == {}
    sync.report("late", {"CPU": 1.0}, quiet_s=3.0)
    clock.now += 3.5
    assert sync.cluster_view()["nodes"] == {} and sync._quiet_until == {}
