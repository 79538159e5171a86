"""Announced preemption in the port: the preemption cases of
`tests/test_train_preemption.py` and
`tests/test_flight_recorder.py::test_preempt_postmortem_capstone`, run on
the port's logical nodes (`init(num_nodes=N)`): chaos's `preempt_node`
grammar and hook, the drain (no new tasks, actors or bundles on a
PREEMPTING node), the node's death after its window, the SIGTERM handler,
and the gang that takes an emergency checkpoint inside the window and
restarts off the node without spending its failure budget. Then a cluster
case: SIGTERM to a port node agent marks it draining in the head's
scheduler, reaches a subscriber on the head once, and the agent leaves
after `preempt_warning_s`.
"""

import os
import signal
import threading
import time

import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu_torch.core import chaos
from ray_tpu_torch.core.scheduler import NodeAffinitySchedulingStrategy


@pytest.fixture
def nodes4():
    """4 logical nodes x 1 CPU: a 3-worker gang spans 3 nodes and leaves
    one free for the restart after the preemption."""
    rt = ray_tpu_torch.init(num_cpus=1, num_nodes=4, detect_accelerators=False)
    yield rt
    chaos.clear_chaos()
    ray_tpu_torch.shutdown()


@pytest.fixture
def nodes2():
    rt = ray_tpu_torch.init(num_cpus=2, num_nodes=2, detect_accelerators=False)
    yield rt
    chaos.clear_chaos()
    ray_tpu_torch.shutdown()


# ------------------------------------------------------------- chaos arming


def test_chaos_preempt_env_parsing(monkeypatch):
    monkeypatch.setenv("RAY_TPU_CHAOS",
                       "preempt_node=1,preempt_warning_s=2.5,name_filter=trig,max_injections=1")
    chaos.load_from_env()
    try:
        cfg = chaos._state.config
        assert cfg.preempt_node is True
        assert cfg.preempt_warning_s == 2.5
        assert cfg.name_filter == "trig"
        assert cfg.max_injections == 1
    finally:
        chaos.clear_chaos()


def test_preempt_hook_fires_once_with_node():
    """preempt_node spends the injection budget and hands (node, warning,
    reason) to the registered hook instead of failing or killing."""
    calls = []
    chaos.set_preemption_hook(lambda node, w, r: calls.append((node, w, r)))
    try:
        chaos.set_chaos(preempt_node=True, preempt_warning_s=1.5, name_filter="victim",
                        max_injections=1)
        chaos.maybe_inject("innocent", node="A")
        assert calls == []
        chaos.maybe_inject("victim-task", node="B")
        assert len(calls) == 1 and calls[0][0] == "B" and calls[0][1] == 1.5
        chaos.maybe_inject("victim-task", node="B")  # budget spent
        assert len(calls) == 1
        # the trigger outside the task boundary runs the same hook
        assert chaos.trigger_preemption("C", 2.0, "drill") is True
        assert calls[-1] == ("C", 2.0, "drill")
        chaos.set_preemption_hook(None)
        assert chaos.trigger_preemption("C", 2.0, "drill") is False
    finally:
        chaos.clear_chaos()
        chaos.set_preemption_hook(None)


# ---------------------------------------------------------- drain semantics


def test_drain_stops_new_placements(nodes2):
    """A PREEMPTING node takes no new task, actor or bundle while it is
    still alive inside its warning window."""
    rt = nodes2
    victim = next(n for n in rt.scheduler.nodes() if not n.is_head)
    rt.preempt_node(victim, warning_s=60.0, reason="drill")
    assert victim.draining and victim.alive

    @ray_tpu_torch.remote
    def where():
        return 1

    ray_tpu_torch.get([where.remote() for _ in range(8)], timeout=30)
    placed = {e["node"] for e in rt.task_events() if e["name"] == "where"}
    assert victim.node_id.hex() not in placed

    # bundle planning skips it: 2 x {CPU: 2} cannot fit on the one placeable node
    from ray_tpu_torch.core.exceptions import PlacementGroupUnschedulableError

    with pytest.raises(PlacementGroupUnschedulableError):
        ray_tpu_torch.placement_group([{"CPU": 2}, {"CPU": 2}], strategy="SPREAD")
    pg = ray_tpu_torch.placement_group([{"CPU": 1}])  # fits the survivor
    assert pg.ready(timeout=10)
    assert pg.bundles[0].node is not victim

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "ok"

    a = A.options(num_cpus=1).remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=10) == "ok"
    for ar in rt._actors.values():
        assert ar._node is not victim

    from ray_tpu_torch.util import state

    states = {n["node_id"]: n["state"] for n in state.list_nodes()}
    assert states[victim.node_id.hex()] == "PREEMPTING"
    assert [g["state"] for g in state.list_placement_groups()] == ["RESERVED"]
    survivor = pg.bundles[0].node.node_id.hex()
    assert rt.scheduler.resident_bundles(survivor) == [[{"CPU": 1}]]
    assert rt.scheduler.resident_bundles(victim.node_id.hex()) == []


def test_preempted_node_dies_after_window(nodes2):
    rt = nodes2
    victim = next(n for n in rt.scheduler.nodes() if not n.is_head)
    rt.preempt_node(victim, warning_s=0.2, reason="drill")
    deadline = time.monotonic() + 10
    while victim.alive and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not victim.alive
    assert victim not in rt.scheduler.nodes()


def test_sigterm_handler_begins_preemption():
    """SIGTERM is an announced preemption, routed into
    ctx.begin_preemption with fate="shutdown"."""
    from ray_tpu_torch.core.health import install_preemption_signal_handler

    calls = []

    class _Ctx:
        def begin_preemption(self, reason, warning_s=None, fate=None):
            calls.append((reason, fate))

    prev = install_preemption_signal_handler(_Ctx())
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not calls and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert calls and calls[0][1] == "shutdown"
    assert "SIGTERM" in calls[0][0]


# ------------------------------------------------------- the gang's drill


def _preempt_train_fn(total, starts, ckpts, emergency):
    def train_fn(config):
        from ray_tpu_torch import train

        ctx = train.get_context()
        state = train.get_checkpoint()
        start = int(state["step"]) + 1 if state is not None else 0
        if ctx.world_rank == 0:
            starts.append(start)
        for step in range(start, total):
            time.sleep(0.02)  # one "train step"
            if ctx.world_rank != 0:
                if train.is_preempted():
                    return "preempted"  # yield: the node dies soon
                continue
            if train.should_checkpoint():
                # the emergency checkpoint, at the CURRENT step
                train.report({"step": step}, checkpoint={"step": step}, checkpoint_step=step)
                emergency.append(step)
                ckpts.append(step)
            elif train.is_preempted():
                return "preempted"  # the emergency checkpoint is down
            elif step % 10 == 9:
                train.report({"step": step}, checkpoint={"step": step}, checkpoint_step=step)
                ckpts.append(step)
            else:
                train.report({"step": step})
        return "done"

    return train_fn


def _drill(rt, tmp_path, name, total, trigger, non_head):
    """Run a 3-worker gang, preempt a node hosting a worker through chaos,
    return (result, victim, starts, emergency)."""
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TrainController

    starts, ckpts, emergency = [], [], []
    controller = TrainController(
        _preempt_train_fn(total, starts, ckpts, emergency), ScalingConfig(num_workers=3),
        RunConfig(name=name, storage_path=str(tmp_path / "trial"),
                  failure=FailureConfig(max_failures=0)),
        train_config={}, restart_backoff_s=0.0)
    box = {}
    thread = threading.Thread(target=lambda: box.update(result=controller.run()), daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while not controller.metrics_history and time.monotonic() < deadline:
        time.sleep(0.02)
    assert controller.metrics_history, "the gang never started reporting"
    chaos.set_chaos(preempt_node=True, preempt_warning_s=3.0, name_filter=trigger,
                    max_injections=1)
    # a node hosting a gang worker: its one CPU is held
    victim = next(n for n in rt.scheduler.nodes()
                  if (not non_head or not n.is_head)
                  and n.resources.available().get("CPU", 0.0) < 0.5)

    @ray_tpu_torch.remote(name=trigger, num_cpus=0)
    def fire():
        return "sent"

    ref = fire.options(scheduling_strategy=NodeAffinitySchedulingStrategy(victim.node_id)).remote()
    assert ray_tpu_torch.get(ref, timeout=30) == "sent"
    thread.join(timeout=120)
    assert not thread.is_alive(), "the controller never finished"
    return box["result"], victim, starts, emergency


def test_preempt_drill_capstone(nodes4, tmp_path):
    """A 3-worker gang under chaos preempt_node: the emergency checkpoint
    lands inside the warning window, the gang restarts OFF the preempting
    node and resumes from that checkpoint, with max_failures=0 (any spend
    of the failure budget would fail the run)."""
    from ray_tpu_torch.train import RunStatus

    result, victim, starts, emergency = _drill(nodes4, tmp_path, "preempt-drill", 60,
                                               "preempt-trigger", non_head=False)
    assert result.status == RunStatus.FINISHED, result.error
    assert result.num_preempt_restarts == 1
    assert result.num_restarts == 0
    assert victim.draining
    assert emergency, "no emergency checkpoint was taken"
    assert len(starts) == 2
    assert starts[1] == max(emergency) + 1
    assert result.checkpoint_step is not None


def test_preempt_postmortem_capstone(nodes4, tmp_path):
    """A preempt_node episode during an in-process run yields ONE
    postmortem bundle whose timeline holds the announcement, the
    emergency checkpoint, the restart and the resumed attempt in causal
    order from two logical nodes; the goodput report attributes the whole
    wall time to buckets, with the same numbers in Result.goodput and the
    goodput gauges."""
    from ray_tpu_torch.train import RunStatus
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.events import events
    from ray_tpu_torch.util.metrics import registry
    from ray_tpu_torch.util.postmortem import load_bundle

    events().clear()
    result, victim, _, _ = _drill(nodes4, tmp_path, "preempt-pm", 40, "pm-trigger",
                                  non_head=True)
    assert result.status == RunStatus.FINISHED, result.error
    assert result.num_preempt_restarts == 1

    out = str(tmp_path / "episode.tgz")
    state.postmortem(out, note="preempt capstone")
    bundle = load_bundle(out)
    evs = bundle["events.jsonl"]

    def first(kind, **match):
        for e in evs:
            extra = e.get("extra") or {}
            if e.get("kind") == kind and all(extra.get(k) == v for k, v in match.items()):
                return e
        raise AssertionError(f"no {kind} event matching {match} in "
                             f"{[(e.get('kind'), e.get('extra')) for e in evs]}")

    announced = first("preempt.announced")
    emergency = first("ckpt.saved", emergency=True)
    restart = first("train.preempt_restart")
    resumed = first("train.gang_started", attempt=2)
    assert announced["ts"] <= emergency["ts"] <= restart["ts"] <= resumed["ts"]
    assert resumed["extra"]["resume_from_step"] is not None
    assert len({e.get("node") for e in (announced, emergency, restart, resumed)}) >= 2
    assert announced["node"] == victim.node_id.hex()

    timeline = bundle["timeline.json"]["traceEvents"]
    marks = {e["args"].get("kind"): e for e in timeline
             if e.get("ph") == "i" and e.get("cat") == "events"}
    for kind in ("preempt.announced", "ckpt.saved", "train.preempt_restart",
                 "train.gang_started"):
        assert kind in marks, sorted(marks)
    slices = [e for e in timeline if e.get("ph") == "X" and e.get("name") == "train.attempt"]
    assert len(slices) >= 2
    lo = min(e["ts"] for e in slices)
    hi = max(e["ts"] + e.get("dur", 0) for e in slices)
    assert lo <= marks["preempt.announced"]["ts"] <= hi

    goodput = result.goodput
    assert goodput is not None and goodput["wall_time_s"] > 0
    total = sum(goodput["buckets"].values())
    assert abs(total - goodput["wall_time_s"]) <= 0.05 * goodput["wall_time_s"]
    for bucket in ("step_compute", "ckpt_save", "preempt_restart", "init"):
        assert goodput["buckets"][bucket] > 0, bucket
    assert 0 < goodput["goodput_fraction"] < 1
    gauge_total = 0.0
    for line in registry().prometheus_text().splitlines():
        if line.startswith("raytpu_train_goodput_seconds") and 'run="preempt-pm"' in line:
            gauge_total += float(line.rsplit(" ", 1)[1])
    assert abs(gauge_total - total) < 1e-3, (gauge_total, total)


# ------------------------------------------------------------ a node agent


def test_sigterm_to_agent_drains_announces_and_leaves():
    """SIGTERM (twice) to a port node agent: the head's scheduler marks the
    node draining, a subscriber on the head hears ONE notice, nothing new
    lands there, and the agent leaves gracefully once `preempt_warning_s`
    has passed since the first signal."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.config import cfg
    from ray_tpu_torch.core.gcs import PREEMPT_CHANNEL

    warning_s = 2.0
    before = torch_process_udfs.live_children()
    c = Cluster(head_node_args={"num_cpus": 1, "_system_config": {
        "node_stale_s": 2.0, "node_heartbeat_s": 0.2}})
    try:
        handle = c.add_node(num_cpus=1, system_config={
            "node_heartbeat_s": 0.2, "preempt_warning_s": warning_s})
        c.wait_for_nodes(2)
        agent = next(n for n in c.runtime.scheduler.nodes() if n.is_remote)
        notices = []
        c.runtime.gcs.pubsub.subscribe(PREEMPT_CHANNEL, notices.append)
        assert ray_tpu_torch.get(ray_tpu_torch.remote(udfs.pid).options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(agent.node_id)).remote(),
            timeout=60) == handle.pid
        t0 = time.monotonic()
        os.kill(handle.pid, signal.SIGTERM)
        deadline = time.monotonic() + 30
        while not agent.draining and time.monotonic() < deadline:
            time.sleep(0.02)
        assert agent.draining and agent.alive
        assert "SIGTERM" in agent.drain_reason
        os.kill(handle.pid, signal.SIGTERM)  # a second notice changes nothing
        # default placement skips the draining agent
        pids = ray_tpu_torch.get([ray_tpu_torch.remote(udfs.pid).options(num_cpus=0).remote()
                                  for _ in range(4)], timeout=60)
        assert handle.pid not in pids
        rc = handle.proc.wait(timeout=60)
        left_s = time.monotonic() - t0
        assert rc == 0, handle.tail()
        assert left_s >= warning_s * 0.9, left_s
        mine = [m for m in notices if m["node_hex"] == agent.node_id.hex()]
        assert len(mine) == 1, notices
        assert mine[0]["warning_s"] == warning_s
        deadline = time.monotonic() + 30
        while any(n.is_remote for n in c.runtime.scheduler.nodes()) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert not any(n.is_remote for n in c.runtime.scheduler.nodes())
    finally:
        c.shutdown()
        cfg.reset()
    assert torch_process_udfs.wait_no_children(before) == [], "an agent outlived its cluster"
