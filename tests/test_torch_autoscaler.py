"""The port's autoscaler: every case of `tests/test_autoscaler.py` run on
the port (demand-driven scale up and down with logical nodes and with real
node-agent processes, the lifecycle rules of scale-down, the drain grace,
bookkeeping when a node dies mid-drain, loud loop errors, the spot
provider's schedule and class limits, unprovisionable demand), and the
`--num-gpus` an autoscaled agent is started with: its node type's GPU
resource, 0 where it has none, so a CPU node type never advertises the
host's cards. The local-provider case's task lives in
`torch_cluster_udfs.py`: agents import what they run by reference.
"""

import os
import time

import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu_torch.core.autoscaler import (Autoscaler, FakeNodeProvider,
                                           LocalProcessNodeProvider, NodeType)
from ray_tpu_torch.core.capacity import agent_command
from ray_tpu_torch.core.config import cfg


@pytest.fixture
def rt1():
    rt = ray_tpu_torch.init(num_cpus=1, detect_accelerators=False)
    yield rt
    ray_tpu_torch.shutdown()


def _big():
    return "ran"


def test_fake_provider_scales_up_and_down(rt1):
    provider = FakeNodeProvider(rt1.scheduler)
    scaler = Autoscaler(rt1.scheduler, provider, [NodeType("cpu4", {"CPU": 4.0})],
                        poll_interval_s=0.05, idle_timeout_s=0.5)
    scaler.start()
    big = ray_tpu_torch.remote(num_cpus=4)(_big)
    # needs 4 CPUs: only a scaled-up node can run it
    assert ray_tpu_torch.get(big.remote(), timeout=60) == "ran"
    assert scaler.stats["scale_ups"] >= 1
    deadline = time.monotonic() + 30
    while scaler.stats["scale_downs"] == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert scaler.stats["scale_downs"] >= 1
    scaler.stop()


def test_local_process_provider_spawns_real_agents():
    """Scale-up starts a real `python -m ray_tpu_torch start` process that
    joins the cluster with `--num-gpus 0` (its type has no GPU); the
    demanded task runs there; scale-down shuts the agent down again."""
    before = torch_process_udfs.live_children()
    rt = ray_tpu_torch.init(num_cpus=1, detect_accelerators=False, head=True,
                            _system_config={"node_heartbeat_s": 0.2, "node_stale_s": 2.5})
    provider = None
    try:
        provider = LocalProcessNodeProvider(rt)
        scaler = Autoscaler(rt.scheduler, provider, [NodeType("worker4", {"CPU": 4.0})],
                            poll_interval_s=0.1, idle_timeout_s=1.0)
        scaler.start()
        pid = ray_tpu_torch.get(ray_tpu_torch.remote(num_cpus=4)(udfs.pid).remote(),
                                timeout=120)
        assert pid != os.getpid(), "the task should run on the autoscaled agent"
        # the task can finish before create_node's join poll returns
        deadline = time.monotonic() + 30
        while scaler.stats["scale_ups"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert scaler.stats["scale_ups"] == 1
        assert provider.pids() == [pid]
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = f.read().decode().split("\0")
        assert argv[argv.index("--num-gpus") + 1] == "0"
        node = next(n for n in rt.scheduler.nodes() if n.is_remote)
        assert node.resources.total.get("GPU", 0.0) == 0.0
        assert node.labels["node_type"] == "worker4" and node.pid == pid
        deadline = time.monotonic() + 60
        while scaler.stats["scale_downs"] == 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert scaler.stats["scale_downs"] == 1
        assert provider.pids() == []
        scaler.stop()
    finally:
        if provider is not None:
            provider.shutdown()
        ray_tpu_torch.shutdown()
        cfg.reset()
    assert torch_process_udfs.wait_no_children(before, timeout=30) == []


def test_shutdown_reaps_an_agent_still_joining():
    """A launch in flight when the provider shuts down (the autoscaler
    stopping mid-scale-up) leaves no orphan agent: create_node raises and
    the spawned process is reaped."""
    import threading

    before = torch_process_udfs.live_children()
    rt = ray_tpu_torch.init(num_cpus=1, detect_accelerators=False, head=True)
    try:
        provider = LocalProcessNodeProvider(rt)
        box = {}

        def launch():
            try:
                box["node"] = provider.create_node(NodeType("late", {"CPU": 1.0}))
            except Exception as exc:  # noqa: BLE001 - the outcome under test
                box["error"] = exc

        thread = threading.Thread(target=launch)
        thread.start()
        deadline = time.monotonic() + 30
        while not provider._starting and time.monotonic() < deadline:
            time.sleep(0.01)
        assert provider._starting, "the agent was never spawned"
        provider.shutdown()
        thread.join(60)
        assert isinstance(box.get("error"), RuntimeError), box
    finally:
        ray_tpu_torch.shutdown()
    assert torch_process_udfs.wait_no_children(before, timeout=30) == []


@pytest.mark.parametrize("resources,gpus,custom", [
    ({"CPU": 4.0}, "0", None),
    ({"CPU": 2.0, "GPU": 1.0}, "1", None),
    ({"CPU": 1.0, "GPU": 2.0, "trainer": 1.0}, "2", '{"trainer": 1.0}'),
])
def test_agent_command_takes_gpus_from_the_node_type(resources, gpus, custom):
    """An autoscaled agent advertises a GPU only where its node type has
    one: `--num-gpus` is the type's GPU resource (0 by default, never left
    to the agent's own detection), the rest are custom resources."""
    cmd = agent_command("127.0.0.1:1234", NodeType("t", resources, capacity_class="spot"),
                        token="tok")
    assert cmd[1:4] == ["-m", "ray_tpu_torch", "start"]
    assert cmd[cmd.index("--num-gpus") + 1] == gpus
    assert cmd[cmd.index("--num-cpus") + 1] == str(int(resources["CPU"]))
    assert ("--resources" in cmd) == (custom is not None)
    if custom is not None:
        assert cmd[cmd.index("--resources") + 1] == custom
    assert cmd[cmd.index("--token") + 1] == "tok"
    assert '"capacity_class": "spot"' in cmd[cmd.index("--labels") + 1]


def test_scale_down_skips_actor_hosting_and_preempting_nodes(rt1):
    """A node hosting a live (even zero-resource) actor is pinned, and a
    PREEMPTING node belongs to the preemption path: neither is selected
    for scale-down."""
    provider = FakeNodeProvider(rt1.scheduler)
    scaler = Autoscaler(rt1.scheduler, provider, [NodeType("cpu4", {"CPU": 4.0})],
                        poll_interval_s=0.05, idle_timeout_s=0.2, drain_grace_s=0.5,
                        runtime=rt1)
    scaler.start()
    big = ray_tpu_torch.remote(num_cpus=4)(_big)
    assert ray_tpu_torch.get(big.remote(), timeout=60) == "ran"
    node = provider.created[0]

    @ray_tpu_torch.remote(num_cpus=0)
    class Pin:
        def ping(self):
            return "pong"

    pin = Pin.options(scheduling_strategy=ray_tpu_torch.NodeAffinitySchedulingStrategy(
        node.node_id)).remote()
    assert ray_tpu_torch.get(pin.ping.remote(), timeout=30) == "pong"
    time.sleep(1.0)  # several idle timeouts
    assert scaler.stats["scale_downs"] == 0
    assert node.alive and not node.draining

    ray_tpu_torch.kill(pin)
    rt1.scheduler.mark_node_draining(node.node_id.hex(), "test preemption",
                                     deadline=time.time() + 60)
    time.sleep(1.0)
    assert scaler.stats["scale_downs"] == 0
    assert node.alive
    scaler.stop()


def test_drain_grace_expiry_forces_termination(rt1):
    """Retirement goes through the drain path: the node is marked draining
    first; work that holds its resources past the grace is cut off."""
    provider = FakeNodeProvider(rt1.scheduler)
    scaler = Autoscaler(rt1.scheduler, provider, [NodeType("cpu4", {"CPU": 4.0})],
                        poll_interval_s=0.05, idle_timeout_s=30.0, drain_grace_s=0.4,
                        runtime=rt1)
    rt1.scheduler.fail_fast_infeasible = False  # step() by hand: no loop races
    ref = ray_tpu_torch.remote(num_cpus=4)(_big).remote()
    scaler.step()  # launches the node for the queued demand
    assert ray_tpu_torch.get(ref, timeout=30) == "ran"
    node = provider.created[0]
    hex_id = node.node_id.hex()
    assert node.resources.try_acquire({"CPU": 1.0})  # work in flight
    scaler._begin_retirement(hex_id, node, "test retirement")
    assert node.draining and node.alive, "the drain path, not a kill"
    scaler.step()
    assert node.alive, "grace not expired: a busy draining node survives"
    time.sleep(0.5)
    scaler.step()  # grace expired: forced termination
    assert not node.alive
    assert scaler.stats["scale_downs"] == 1


def test_bookkeeping_survives_node_dying_mid_drain(rt1):
    """A managed node that dies while draining leaves every table (no
    idle clock, no count left behind) and the autoscaler keeps scaling."""
    provider = FakeNodeProvider(rt1.scheduler)
    scaler = Autoscaler(rt1.scheduler, provider, [NodeType("cpu4", {"CPU": 4.0})],
                        poll_interval_s=0.05, idle_timeout_s=30.0, drain_grace_s=30.0,
                        runtime=rt1)
    rt1.scheduler.fail_fast_infeasible = False
    big = ray_tpu_torch.remote(num_cpus=4)(_big)
    ref = big.remote()
    scaler.step()
    assert ray_tpu_torch.get(ref, timeout=30) == "ran"
    node = provider.created[0]
    node.resources.try_acquire({"CPU": 1.0})  # keep the drain open
    scaler._begin_retirement(node.node_id.hex(), node, "test retirement")
    assert node.draining
    assert scaler.status()["retiring"] == 1
    rt1.scheduler.remove_node(node.node_id)  # the node dies mid-drain
    scaler.step()
    status = scaler.status()
    assert status["managed_nodes"] == 0
    assert status["retiring"] == 0
    assert status["per_type"].get("cpu4", 0) == 0
    assert scaler.stats["scale_downs"] == 0  # not a policy retirement
    ref2 = big.remote()
    scaler.step()
    assert ray_tpu_torch.get(ref2, timeout=30) == "ran"
    assert scaler.stats["scale_ups"] == 2


def test_loop_error_is_loud_once_per_type(rt1):
    """The loop survives exceptions, loudly: every error counts, and each
    exception type emits exactly one autoscaler.error event."""
    from ray_tpu_torch.util import state

    provider = FakeNodeProvider(rt1.scheduler)
    scaler = Autoscaler(rt1.scheduler, provider, [NodeType("cpu4", {"CPU": 4.0})],
                        poll_interval_s=0.02, idle_timeout_s=5.0)

    def boom():
        raise ValueError("wedged control loop")

    scaler.step = boom
    scaler.start()
    deadline = time.monotonic() + 10
    while scaler.stats["loop_errors"] < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    scaler.stop()
    assert scaler.stats["loop_errors"] >= 3
    errors = [e for e in state.list_events(limit=500)
              if e.get("kind") == "autoscaler.error"
              and e.get("extra", {}).get("error_type") == "ValueError"]
    assert len(errors) == 1, errors


def test_spot_provider_schedule_and_class_limits(rt1):
    """SpotNodeProvider labels its nodes spot and reclaims them through the
    real announced-preemption path; a class limit caps how many spot nodes
    the planner may launch, for a whole gang or none of it."""
    from ray_tpu_torch.core.capacity import SpotNodeProvider

    inner = FakeNodeProvider(rt1.scheduler)
    provider = SpotNodeProvider(inner, schedule=[None], warning_s=0.2, seed=7)
    scaler = Autoscaler(rt1.scheduler, provider,
                        [NodeType("spot2", {"CPU": 2.0}, capacity_class="spot")],
                        poll_interval_s=0.05, idle_timeout_s=60.0, runtime=rt1,
                        class_limits={"spot": 1})
    scaler.start()
    assert ray_tpu_torch.get(ray_tpu_torch.remote(num_cpus=2)(_big).remote(),
                             timeout=30) == "ran"
    node = inner.created[0]
    assert node.labels["capacity_class"] == "spot"
    assert scaler.status()["per_class"] == {"spot": 1}

    pg = ray_tpu_torch.api.placement_group([{"CPU": 2.0}, {"CPU": 2.0}], strategy="PACK")
    deadline = time.monotonic() + 10
    while scaler.stats["blocked"] == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert scaler.stats["blocked"] >= 1
    assert len(inner.created) == 1, "no partial gang launches"
    scaler.class_limits["spot"] = 3  # raising the limit unblocks the whole gang
    assert pg.wait_reserved(timeout=15), pg.state

    provider.preempt_after(node, 0.01, warning_s=0.2)
    deadline = time.monotonic() + 10
    while not node.draining and time.monotonic() < deadline:
        time.sleep(0.02)
    assert node.draining, "the reclaim goes through PREEMPTING"
    deadline = time.monotonic() + 10
    while node.alive and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not node.alive
    assert provider.num_preemptions() == 1
    scaler.stop()


def test_unprovisionable_demand_fails_loudly(rt1):
    """With an autoscaler attached, demand no node type can ever hold
    raises OutOfResourcesError instead of waiting forever; with none, the
    port fails it at once, as before."""
    from ray_tpu_torch.core.exceptions import OutOfResourcesError

    provider = FakeNodeProvider(rt1.scheduler)
    scaler = Autoscaler(rt1.scheduler, provider, [NodeType("cpu4", {"CPU": 4.0})],
                        poll_interval_s=0.05, idle_timeout_s=5.0)
    scaler.start()
    impossible = ray_tpu_torch.remote(num_cpus=64)(_big)
    with pytest.raises(OutOfResourcesError):
        ray_tpu_torch.get(impossible.remote(), timeout=30)
    scaler.stop()
    assert rt1.scheduler.fail_fast_infeasible
    with pytest.raises(OutOfResourcesError):
        ray_tpu_torch.get(ray_tpu_torch.remote(num_cpus=4)(_big).remote(), timeout=30)
