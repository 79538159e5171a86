"""Placement groups across the port's node agents and Train gangs hosted by
the cluster: every case of `tests/test_cluster_pg.py` run on the port.

The reservation is a two-phase commit (each agent's own ledger holds the
bundle; a refusal rolls the group back), work aimed at a remote bundle
runs on its agent, a bundle host's death moves the group RESERVED ->
RESCHEDULING -> RESERVED on a spare agent (or FAILED with its death
history when the budget is spent), a budgeted bundle actor follows its
bundle, and a `ClusterWorkerGroup` re-meshes after a node death and
resumes from its latest checkpoint. Node kills go through chaos's
`kill_node` mode, armed on the agents through `RAY_TPU_CHAOS`.

JAX skips its cluster-hosted gang on the CPU (XLA has no multi-process
CPU backend); the port runs it over gloo, two process actors on two
agents, and its losses equal JAX's single-process dp=2 run on two of the
8 CPU devices (llama-tiny, f32, 3 steps, from JAX's initial state) at
`tests/test_torch_multihost.py`'s tolerance. What the agents run lives in
`torch_cluster_udfs.py` (pickled by reference). Tests that kill no node
share one cluster; a test that kills a node owns its cluster.
"""

import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.scheduler import (NodeAffinitySchedulingStrategy,
                                          PlacementGroupSchedulingStrategy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAOS_KILL_ENV = {"RAY_TPU_CHAOS": "kill_node=1,name_filter=chaos-kill,max_injections=1"}
N = 2
STEPS = 3
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def _teardown(c, before):
    c.shutdown()
    cfg.reset()  # _system_config overrides must not leak across tests
    assert torch_process_udfs.wait_no_children(before, timeout=30) == [], \
        "an agent or a gang member outlived its cluster"


@pytest.fixture(scope="class")
def gang_cluster():
    """Head (1 CPU, no 'gang' resource) + 2 agents with gang:1 each: a
    2-bundle gang group MUST span both agents."""
    before = torch_process_udfs.live_children()
    c = Cluster(head_node_args={"num_cpus": 1, "_system_config": {
        "node_stale_s": 5.0, "node_heartbeat_s": 0.2}})
    for _ in range(2):
        c.add_node(num_cpus=2, resources={"gang": 1}, system_config={"node_heartbeat_s": 0.2})
    c.wait_for_nodes(3)
    yield c
    _teardown(c, before)


def _failover(agents: int):
    """Head (1 CPU) + `agents` agents with gang:1 each, armed with a chaos
    kill_node trigger: a task named 'chaos-kill' on an agent kills it."""
    c = Cluster(head_node_args={"num_cpus": 1, "_system_config": {
        "node_stale_s": 2.0, "node_heartbeat_s": 0.2, "pg_reschedule_backoff_s": 0.2}})
    for _ in range(agents):
        c.add_node(num_cpus=3, resources={"gang": 1},
                   system_config={"node_heartbeat_s": 0.2, "node_stale_s": 2.0},
                   env=dict(CHAOS_KILL_ENV))
    c.wait_for_nodes(1 + agents)
    return c


@pytest.fixture
def failover_cluster():
    """3 gang agents: a 2-bundle STRICT_SPREAD group leaves one spare."""
    before = torch_process_udfs.live_children()
    c = _failover(3)
    yield c
    _teardown(c, before)


@pytest.fixture
def single_agent_cluster():
    before = torch_process_udfs.live_children()
    c = _failover(1)
    yield c
    _teardown(c, before)


def _agent_available(resource):
    """Each gang agent's view of its OWN free `resource` (a probe task)."""
    probe = ray_tpu_torch.remote(num_cpus=0)(udfs.ledger_available)
    out = {}
    for n in ray_tpu_torch.core.runtime.get_runtime().scheduler.nodes():
        if n.is_remote and n.resources.total.get(resource, 0.0) > 0:
            avail = ray_tpu_torch.get(probe.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(n.node_id)).remote(),
                timeout=60)
            out[n.node_id.hex()] = avail.get(resource, 0.0)
    return out


def _agent_pids(cluster):
    return {rec["node_id"]: rec["pid"] for rec in cluster.runtime.cluster.nodes()
            if not rec["is_head"]}


def _chaos_kill_node(node_id):
    """Kill a node through chaos: a task named to match the agents'
    kill_node filter, pinned to the victim (its result never arrives)."""
    ray_tpu_torch.remote(udfs.const).options(
        name="chaos-kill", num_cpus=0,
        scheduling_strategy=NodeAffinitySchedulingStrategy(node_id)).remote("unreachable")


def _pg_event_states(pg):
    from ray_tpu_torch.util.events import events

    return [e["extra"]["state"] for e in events().list(source="placement_groups", limit=100000)
            if e.get("extra", {}).get("pg") == pg.id.hex() and e["extra"].get("state")]


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def _global_tokens(vocab):
    """JAX's multihost test batch: the global (8, 33) batch of arange."""
    return np.arange(8 * 33, dtype=np.int32).reshape(8, 33) % vocab


def _jax_dp2_run():
    """JAX's dp=2 run on two devices of this process: its initial state (as
    numpy namespaces) and its losses (`tests/test_torch_multihost.py`)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.models import get_config as jget_config
    from ray_tpu.parallel import MeshSpec as JMeshSpec, build_mesh as jbuild_mesh
    from ray_tpu.train import create_train_state, default_optimizer, make_train_step
    from ray_tpu_torch.train.lm import _adam_state

    model = jget_config("llama-tiny").replace(dtype=jnp.float32)
    mesh = jbuild_mesh(JMeshSpec(dp=N), devices=jax.devices()[:N])
    opt = default_optimizer(1e-3, total_steps=10)
    state, shardings = create_train_state(model, opt, jax.random.PRNGKey(0), mesh)
    s = jax.tree.map(np.asarray, state)
    adam = _adam_state(s.opt_state)
    init = types.SimpleNamespace(step=s.step, params=s.params, ef=None, opt_state=types.SimpleNamespace(
        count=adam.count, mu=adam.mu, nu=adam.nu))
    step = make_train_step(model, opt, mesh, state_shardings=shardings)
    tokens = jax.device_put(jnp.asarray(_global_tokens(model.vocab_size)),
                            NamedSharding(mesh, JP("dp", None)))
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
    return init, losses


# ------------------------------------------- a cluster that loses no node


class TestGangCluster:
    """The cases that kill no node share one cluster (`gang_cluster`)."""

    def test_pg_reserves_across_agents_and_releases(self, gang_cluster):
        """A 2-bundle gang group spans both agents: each agent's OWN ledger
        holds its bundle (phase 2 landed), and removal gives it back."""
        pg = ray_tpu_torch.placement_group([{"gang": 1}, {"gang": 1}], strategy="STRICT_SPREAD")
        assert pg.ready(timeout=10)
        assert len({b.node.node_id.hex() for b in pg.bundles}) == 2
        assert all(b.node.is_remote for b in pg.bundles)
        held = _agent_available("gang")
        assert list(held.values()) == [0.0, 0.0], f"agent ledgers: {held}"
        rec = gang_cluster.runtime.cluster.gcs.pg_state(pg.id.hex())
        assert rec["state"] == "RESERVED"
        assert [b["node"] for b in rec["bundles"]] == [b.node.node_id.hex() for b in pg.bundles]

        ray_tpu_torch.remove_placement_group(pg)
        _wait(lambda: list(_agent_available("gang").values()) == [1.0, 1.0], 30,
              "the agents' ledgers to get their bundles back")
        assert gang_cluster.runtime.cluster.gcs.pg_state(pg.id.hex()) is None

    def test_pg_atomic_rollback_on_agent_refusal(self, gang_cluster):
        """A second process that joined the cluster holds one agent's gang
        slot where this one cannot see it: our 2-bundle STRICT_SPREAD group
        fails as a whole, and the OTHER agent's prepared bundle rolls back."""
        import tempfile

        from ray_tpu_torch.core.exceptions import PlacementGroupUnschedulableError

        script = textwrap.dedent("""
            import sys, time
            import ray_tpu_torch

            address, flag = sys.argv[1], sys.argv[2]
            ray_tpu_torch.init(address=address, num_cpus=0, detect_accelerators=False)
            deadline = time.monotonic() + 60
            while ray_tpu_torch.cluster_resources().get("gang", 0) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.1)
            pg = ray_tpu_torch.placement_group([{"gang": 1}])
            assert pg.ready(timeout=10)
            open(flag, "w").write("held")
            time.sleep(15)  # hold the slot while the head process tries
            ray_tpu_torch.shutdown()
        """)
        fd, flag = tempfile.mkstemp(prefix="ray_tpu_torch_pgflag_")
        os.close(fd)
        os.unlink(flag)
        second = subprocess.Popen(
            [sys.executable, "-c", script, gang_cluster.address, flag], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": REPO})
        try:
            deadline = time.monotonic() + 90
            while not os.path.exists(flag):
                assert second.poll() is None, second.communicate()[0]
                assert time.monotonic() < deadline
                time.sleep(0.1)
            # our view still believes both agents have gang:1 free: phase 2 at
            # the occupied agent must refuse, and the whole group must fail
            with pytest.raises(PlacementGroupUnschedulableError, match="refused"):
                ray_tpu_torch.placement_group([{"gang": 1}, {"gang": 1}], strategy="STRICT_SPREAD")
            held = _agent_available("gang")
            assert sorted(held.values()) == [0.0, 1.0], f"rollback failed, agent ledgers: {held}"
        finally:
            second.kill()
            second.communicate()
            os.path.exists(flag) and os.unlink(flag)
        # the second process died holding its bundle: once its node ages out,
        # the agent gives the bundle it reserved back to the ledger
        _wait(lambda: list(_agent_available("gang").values()) == [1.0, 1.0], 60,
              "the dead process's bundle to return to the agent's ledger")

    def test_task_and_actor_run_inside_remote_bundle(self, gang_cluster):
        """Work scheduled into a remote bundle runs ON that bundle's node,
        leasing from the reserved pool; its release gives the bundle back."""
        pg = ray_tpu_torch.placement_group([{"gang": 1, "CPU": 1}, {"gang": 1, "CPU": 1}],
                                           strategy="STRICT_SPREAD")
        assert pg.ready(timeout=10)
        agent_pids = _agent_pids(gang_cluster)
        whoami = ray_tpu_torch.remote(num_cpus=1, resources={"gang": 1})(udfs.pid)
        for idx, bundle in enumerate(pg.bundles):
            pid = ray_tpu_torch.get(whoami.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
                pg, placement_group_bundle_index=idx)).remote(), timeout=60)
            assert pid == agent_pids[bundle.node.node_id.hex()]
        member = ray_tpu_torch.remote(num_cpus=1, resources={"gang": 1})(udfs.Member).options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                pg, placement_group_bundle_index=1)).remote()
        pid = ray_tpu_torch.get(member.where.remote(), timeout=60)
        assert pid == agent_pids[pg.bundles[1].node.node_id.hex()]
        ray_tpu_torch.kill(member)
        ray_tpu_torch.remove_placement_group(pg)
        _wait(lambda: list(_agent_available("gang").values()) == [1.0, 1.0], 30,
              "the bundles' release, the actor's share included")

    def test_cluster_hosted_train_gang_matches_jax_dp2_run(self, gang_cluster):
        """A 2-member gloo gang whose members are process actors hosted by two
        different agents (a STRICT_SPREAD group, one bundle per agent), each
        a child of its agent: both ranks' losses equal JAX's dp=2 run, and
        the reports stream back from both ranks over the actor plane."""
        from ray_tpu_torch.models import get_config
        from ray_tpu_torch.train import ClusterWorkerGroup

        init, jlosses = _jax_dp2_run()
        config = {"model": "llama-tiny", "init": init,
                  "tokens": _global_tokens(get_config("llama-tiny").vocab_size), "steps": STEPS,
                  "lr": 1e-3, "total_steps": 10, "device": "cpu", "threads": 1}
        group = ClusterWorkerGroup(N, resources_per_worker={"CPU": 1, "gang": 1},
                                   run_name="cluster-gang", backend="gloo", timeout_s=120)
        try:
            group.start()
            assert len({b.node.node_id.hex() for b in group.pg.bundles}) == N
            assert all(b.node.is_remote for b in group.pg.bundles)
            agent_pids = _agent_pids(gang_cluster)
            where = group.where()
            for b, w in zip(group.pg.bundles, where):
                assert w["ppid"] == agent_pids[b.node.node_id.hex()], where
            refs = group.run_async(udfs.gang_lm, config)
            deadline = time.monotonic() + 300
            cursors, reports = [0] * N, []
            while time.monotonic() < deadline:
                polls = group.poll(cursors)
                for i, p in enumerate(polls):
                    reports.extend(p["reports"])
                    cursors[i] += len(p["reports"])
                    assert not p["error"], p["error"]
                if all(p["done"] for p in polls):
                    break
                time.sleep(0.1)
            results = group.finish(refs, timeout=60)
        finally:
            group.shutdown()
        for member_losses in results:
            np.testing.assert_allclose(member_losses, jlosses, **STEP_TOL)
        assert {r[2] for r in reports} == {0, 1}
        assert [r[0]["step"] for r in reports if r[2] == 0] == list(range(STEPS))


# ---------------------------------------------------------------- failover


def test_pg_reschedules_bundle_after_node_death(failover_cluster):
    """Kill bundle 1's host: the group goes RESERVED -> RESCHEDULING ->
    RESERVED with the bundle re-reserved on the spare agent; tasks aimed
    at the bundle land there."""
    pg = ray_tpu_torch.placement_group([{"gang": 1}, {"gang": 1}], strategy="STRICT_SPREAD")
    assert pg.ready(timeout=10)
    assert pg.state == "RESERVED"
    agent_pids = _agent_pids(failover_cluster)
    victim_hex = pg.bundles[1].node.node_id.hex()
    spare = set(agent_pids) - {b.node.node_id.hex() for b in pg.bundles}
    assert len(spare) == 1

    _chaos_kill_node(pg.bundles[1].node.node_id)
    _wait(lambda: pg.state == "RESERVED" and pg.bundles[1].node is not None
          and pg.bundles[1].node.node_id.hex() != victim_hex, 60, "the re-reservation")
    assert pg.bundles[1].node.node_id.hex() in spare
    assert pg.reschedules_used >= 1
    assert pg.death_history and victim_hex[:12] in pg.death_history[0]["reason"]
    held = _agent_available("gang")
    assert list(held.values()) == [0.0, 0.0], f"agent ledgers: {held}"

    whoami = ray_tpu_torch.remote(num_cpus=0, resources={"gang": 1})(udfs.pid)
    pid = ray_tpu_torch.get(whoami.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
        pg, placement_group_bundle_index=1)).remote(), timeout=60)
    assert pid == agent_pids[pg.bundles[1].node.node_id.hex()]

    states = _pg_event_states(pg)
    assert states[0] == "RESERVED" and "RESCHEDULING" in states and states[-1] == "RESERVED"
    rec = failover_cluster.runtime.cluster.gcs.pg_state(pg.id.hex())
    assert rec["state"] == "RESERVED"
    assert rec["reschedules_used"] >= 1
    assert rec["death_history"]
    ray_tpu_torch.remove_placement_group(pg)


def test_bundle_actor_restarts_into_rescheduled_bundle(failover_cluster):
    """A max_restarts-budgeted actor in a bundle follows its bundle: node
    death -> the group re-reserves on the spare -> the actor (ALIVE ->
    RESTARTING -> ALIVE) lands on the bundle's new host."""
    pg = ray_tpu_torch.placement_group([{"gang": 1, "CPU": 1}, {"gang": 1, "CPU": 1}],
                                       strategy="STRICT_SPREAD")
    assert pg.ready(timeout=10)
    agent_pids = _agent_pids(failover_cluster)
    member = ray_tpu_torch.remote(num_cpus=1, resources={"gang": 1}, max_restarts=1)(
        udfs.Member).options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=1)).remote()
    old_pid = ray_tpu_torch.get(member.where.remote(), timeout=60)
    victim_hex = pg.bundles[1].node.node_id.hex()
    assert old_pid == agent_pids[victim_hex]

    _chaos_kill_node(pg.bundles[1].node.node_id)
    new_pid = None
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        try:
            new_pid = ray_tpu_torch.get(member.where.remote(), timeout=30)
            if new_pid != old_pid:
                break
        except Exception:  # noqa: BLE001 - calls fail until the restart lands
            time.sleep(0.3)
    assert new_pid is not None and new_pid != old_pid
    new_hex = pg.bundles[1].node.node_id.hex()
    assert new_hex != victim_hex
    assert new_pid == agent_pids[new_hex]
    ray_tpu_torch.kill(member)
    ray_tpu_torch.remove_placement_group(pg)


def test_pg_budget_exhausted_fails_with_death_history(single_agent_cluster):
    """max_reschedules=0: the first bundle-host death spends the budget;
    the group lands in FAILED and tasks aimed at it fail with the death
    history."""
    from ray_tpu_torch.core.exceptions import OutOfResourcesError

    pg = ray_tpu_torch.placement_group([{"gang": 1}], max_reschedules=0)
    assert pg.ready(timeout=10)
    victim_hex = pg.bundles[0].node.node_id.hex()
    _chaos_kill_node(pg.bundles[0].node.node_id)
    _wait(lambda: pg.state == "FAILED", 60, "the group to fail")
    assert "death history" in pg.failure_reason
    assert victim_hex[:12] in pg.failure_reason
    assert not pg.wait_reserved(timeout=1)
    doomed = ray_tpu_torch.remote(num_cpus=0, resources={"gang": 1})(udfs.const)
    with pytest.raises(OutOfResourcesError, match="death history"):
        ray_tpu_torch.get(doomed.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(pg)).remote(1), timeout=30)
    assert _pg_event_states(pg)[-1] == "FAILED"
    ray_tpu_torch.remove_placement_group(pg)


def test_cluster_gang_remesh_on_node_death(failover_cluster):
    """The failover capstone: kill the agent hosting bundle 1 mid-run. The
    group re-reserves on the spare node, the controller re-meshes the gang
    there with a newly elected coordinator, training resumes from the
    latest checkpoint (no step replays) and the loss curve runs on to the
    end."""
    import threading

    from ray_tpu_torch.train import (ClusterWorkerGroup, FailureConfig, RunConfig, RunStatus,
                                     ScalingConfig, TrainController)

    pg = ray_tpu_torch.placement_group([{"CPU": 1, "gang": 1}, {"CPU": 1, "gang": 1}],
                                       strategy="STRICT_SPREAD")
    assert pg.ready(timeout=10)
    victim_hex = pg.bundles[1].node.node_id.hex()
    groups = []

    def factory():
        groups.append(ClusterWorkerGroup(
            2, resources_per_worker={"CPU": 1, "gang": 1}, run_name="failover-gang", pg=pg,
            init_distributed=False, pg_wait_s=60))
        return groups[-1]

    total_steps = 40
    controller = TrainController(
        udfs.gang_steps, ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1, "gang": 1}),
        RunConfig(name="failover-gang", failure=FailureConfig(max_failures=10)),
        train_config={"total_steps": total_steps, "step_s": 0.25},
        group_factory=factory, restart_backoff_s=0.5)
    box = {}
    runner = threading.Thread(target=lambda: box.update(result=controller.run()), daemon=True)
    runner.start()
    _wait(lambda: len(controller.metrics_history) >= 3, 120, "three reported steps")
    _chaos_kill_node(pg.bundles[1].node.node_id)
    runner.join(timeout=240)
    assert not runner.is_alive(), "the controller never finished after the failover"
    result = box["result"]
    assert result.status == RunStatus.FINISHED, result.error
    assert result.error is None
    assert result.num_restarts >= 1
    steps = [m["step"] for m in result.metrics_history]
    assert steps[0] == 0 and steps[-1] == total_steps - 1
    assert steps == sorted(set(steps)), "steps replayed or reordered"
    losses = [m["loss"] for m in result.metrics_history]
    assert losses == sorted(losses, reverse=True), "the loss curve broke"
    assert result.checkpoint_step == total_steps - 1
    assert pg.state == "RESERVED"
    assert victim_hex not in {b.node.node_id.hex() for b in pg.bundles}
    assert pg.reschedules_used >= 1
    assert len(groups) >= 2
    assert groups[-1]._coordinator != groups[0]._coordinator
    states = _pg_event_states(pg)
    assert states[0] == "RESERVED" and "RESCHEDULING" in states and states[-1] == "RESERVED"
    ray_tpu_torch.remove_placement_group(pg)
