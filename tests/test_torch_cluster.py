"""The port's cluster mode (`ray_tpu_torch/core/cluster.py`,
`cluster_utils.py`, `cli.py`): every case of `tests/test_cluster.py` run
on the port, over real node-agent processes (`python -m ray_tpu_torch
start --address ...`) joined to a head in this process — the cluster
view, remote dispatch, chunked transfer of results, node-death failover,
remote actors and borrowed references — and the membership refusals
across packages (a port node against a JAX head, a JAX node against a
port head).

What an agent runs is pickled by reference, so the tasks and actors live
in the root module `torch_cluster_udfs.py`. Tests that kill or remove a
node own their cluster; the rest share one (`TestSharedCluster`).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.exceptions import ActorDiedError, TaskError
from ray_tpu_torch.core.object_store import Tier
from ray_tpu_torch.core.scheduler import NodeAffinitySchedulingStrategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD = {"num_cpus": 2, "_system_config": {"node_stale_s": 2.5, "node_heartbeat_s": 0.2}}
AGENT = {"node_heartbeat_s": 0.2}


def _cluster(head=None, agents=2, **agent_kw):
    c = Cluster(head_node_args=dict(head or HEAD))
    for _ in range(agents):
        c.add_node(num_cpus=2, system_config=AGENT, **agent_kw)
    c.wait_for_nodes(1 + agents)
    return c


def _teardown(c, before):
    c.shutdown()
    cfg.reset()  # _system_config overrides must not leak across tests
    assert torch_process_udfs.wait_no_children(before) == [], "an agent outlived its cluster"


@pytest.fixture(scope="class")
def shared():
    """Head (2 CPUs, in-process) + 2 agents (2 CPUs each), for the tests
    that kill no node."""
    before = torch_process_udfs.live_children()
    c = _cluster()
    yield c
    _teardown(c, before)


@pytest.fixture
def own():
    """A cluster of its own, for a test that kills or removes a node."""
    before = torch_process_udfs.live_children()
    c = _cluster()
    yield c
    _teardown(c, before)


def _remote_nodes(c):
    return [n for n in c.runtime.scheduler.nodes() if n.is_remote]


def _on(node):
    return NodeAffinitySchedulingStrategy(node.node_id)


def _record(c, node):
    return next(rec for rec in c.runtime.cluster.nodes()
                if rec["node_id"] == node.node_id.hex())


def test_agent_kill_fails_over(own):
    """SIGKILL an agent mid-task: the task resubmits (system-failure
    budget) and completes elsewhere."""
    slow = ray_tpu_torch.remote(num_cpus=1)(udfs.hold_pid)
    refs = [slow.remote(1.5) for _ in range(6)]  # saturate: agents hold tasks
    time.sleep(0.4)
    own.remove_node(own._nodes[0], allow_graceful=False)
    pids = ray_tpu_torch.get(refs, timeout=120)
    assert len(pids) == 6 and all(isinstance(p, int) for p in pids)
    deadline = time.monotonic() + 30
    while len(own.runtime.scheduler.nodes()) > 2 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert len(own.runtime.scheduler.nodes()) == 2


def test_graceful_remove_deregisters(own):
    own.remove_node(own._nodes[1], allow_graceful=True)
    deadline = time.monotonic() + 30
    while len(own.runtime.scheduler.nodes()) > 2 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert len(own.runtime.scheduler.nodes()) == 2
    assert len(own.runtime.cluster.nodes()) == 2  # its GCS entry is gone too
    assert ray_tpu_torch.get(ray_tpu_torch.remote(udfs.const).remote(7), timeout=60) == 7


def test_rpc_auth_token_required():
    """A tokenless client is dropped before any unpickling."""
    from ray_tpu_torch.core.rpc import RpcAuthError, RpcClient, RpcError, RpcServer

    server = RpcServer({"ping": lambda: "ok"}, token="sekrit")
    try:
        good = RpcClient(server.url, token="sekrit", timeout=5.0)
        assert good.call("ping") == "ok"
        good.close()
        bad = RpcClient(server.url, token="wrong", timeout=5.0, retries=0)
        with pytest.raises(RpcAuthError):
            bad.call("ping")
        bad.close()
        none = RpcClient(server.url, timeout=5.0, retries=0)
        with pytest.raises(RpcError):
            none.call("ping")
        none.close()
    finally:
        server.stop()


# ------------------------------------------------------------- remote actors


def test_remote_actor_spillover_and_named_lookup():
    """Default placement spills to an agent when only IT has the
    resources; the name resolves cluster-wide."""
    before = torch_process_udfs.live_children()
    c = _cluster(agents=0)
    try:
        c.add_node(num_cpus=1, resources={"accel": 2}, system_config=AGENT)
        c.wait_for_nodes(2)
        w = ray_tpu_torch.remote(resources={"accel": 1})(udfs.Where).options(
            name="accel-worker").remote()
        pid = ray_tpu_torch.get(w.where.remote(), timeout=60)
        assert pid != os.getpid()
        again = ray_tpu_torch.get_actor("accel-worker")
        assert ray_tpu_torch.get(again.where.remote(), timeout=60) == pid
    finally:
        _teardown(c, before)


def test_remote_actor_error_and_node_death(own):
    """User exceptions cross the wire; killing the hosting agent fails the
    pending and the future calls with ActorDiedError."""
    target = _remote_nodes(own)[0]
    actor = ray_tpu_torch.remote(udfs.Flaky).options(scheduling_strategy=_on(target)).remote()
    with pytest.raises((TaskError, RuntimeError), match="actor kaboom"):
        ray_tpu_torch.get(actor.boom.remote(), timeout=60)
    pending = actor.slow.remote()
    time.sleep(0.5)  # let the call land on the agent
    pid = _record(own, target)["pid"]
    own.remove_node(next(h for h in own._nodes if h.pid == pid), allow_graceful=False)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(pending, timeout=60)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(actor.slow.remote(), timeout=60)


# ------------------------------------------------- membership across packages


def test_port_node_refuses_jax_head():
    """A port node refuses a JAX head, naming both packages, and leaves
    nothing running."""
    import threading

    from ray_tpu.core.runtime import Runtime as JaxRuntime
    from ray_tpu_torch.core.runtime import Runtime

    jax_head = JaxRuntime(num_cpus=1, detect_accelerators=False, head=True)
    try:
        threads = {t.ident for t in threading.enumerate()}
        with pytest.raises(RuntimeError, match=r"ray_tpu \(JAX\) head.*ray_tpu_torch"):
            Runtime(num_cpus=1, detect_accelerators=False,
                    address=jax_head.cluster.gcs_address)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            left = [t for t in threading.enumerate()
                    if t.ident not in threads and "ray_tpu_torch" in t.name]
            if not left:
                break
            time.sleep(0.05)
        assert not left, [t.name for t in left]
    finally:
        jax_head.shutdown()


class TestSharedCluster:
    """The tests that kill no node share one cluster (class-scoped: one
    process holds one runtime, so it must be down before a test that owns
    a cluster starts)."""

    def test_cluster_resources_union(self, shared):
        assert ray_tpu_torch.cluster_resources().get("CPU", 0) == 6.0
        assert len(shared.runtime.scheduler.nodes()) == 3
        infos = shared.runtime.cluster.nodes()
        assert len(infos) == 3 and sum(1 for i in infos if i["is_head"]) == 1
        assert all(i["protocol"] == "torch-1" for i in infos)

    def test_remote_task_executes_on_agent(self, shared):
        # 6 concurrent 1-CPU tasks > the head's 2 CPUs: some MUST land on agents
        hold = ray_tpu_torch.remote(num_cpus=1)(udfs.hold_pid)
        pids = set(ray_tpu_torch.get([hold.remote(0.5) for _ in range(6)], timeout=60))
        assert len(pids) >= 2, f"all tasks ran in one process: {pids}"

    def test_node_affinity_targets_remote_agent(self, shared):
        remote_nodes = _remote_nodes(shared)
        assert len(remote_nodes) == 2
        target = remote_nodes[0]
        pid = ray_tpu_torch.get(
            ray_tpu_torch.remote(udfs.pid).options(scheduling_strategy=_on(target)).remote(),
            timeout=60)
        assert pid != os.getpid()
        assert _record(shared, target)["pid"] == pid  # THAT node's process

    def test_large_result_pulled_over_wire(self, shared):
        """A big result stays on the agent; get() pulls it through the
        transfer plane (REMOTE tier fetch-through)."""
        target = _remote_nodes(shared)[0]
        ref = ray_tpu_torch.remote(udfs.arange_f64).options(
            scheduling_strategy=_on(target)).remote(1_000_000)  # 8 MB >> the inline cutoff
        entry = shared.runtime.object_store.entry(ref.object_id)
        deadline = time.monotonic() + 60
        while not entry.event.is_set() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert entry.tier == Tier.REMOTE  # a placeholder before the first get
        value = ray_tpu_torch.get(ref, timeout=60)
        assert value.shape == (1_000_000,) and float(value[12345]) == 12345.0
        assert entry.tier != Tier.REMOTE  # cached locally now

    def test_objectref_arg_roundtrip(self, shared):
        """ObjectRef args resolve at the owner and ship by value; results
        chain across processes."""
        produce = ray_tpu_torch.remote(num_cpus=1)(udfs.ones_f32)
        consume = ray_tpu_torch.remote(num_cpus=1)(udfs.total)
        refs = [produce.remote(4096) for _ in range(4)]
        assert ray_tpu_torch.get([consume.remote(r) for r in refs], timeout=60) == [4096.0] * 4

    def test_remote_task_error_propagates(self, shared):
        ref = ray_tpu_torch.remote(udfs.raise_value_error).options(
            scheduling_strategy=_on(_remote_nodes(shared)[0])).remote("remote kaboom")
        with pytest.raises(TaskError) as ei:
            ray_tpu_torch.get(ref, timeout=60)
        assert "remote kaboom" in str(ei.value)
        assert isinstance(ei.value.cause, ValueError)

    def test_streaming_generator_on_remote_agent(self, shared):
        """num_returns="streaming" tasks dispatch to agents: each yield flows
        back over the stream_item plane as it is produced."""
        stream = ray_tpu_torch.remote(udfs.gen_pid).options(
            num_returns="streaming", scheduling_strategy=_on(_remote_nodes(shared)[0])).remote(5)
        items = [ray_tpu_torch.get(r, timeout=60) for r in stream]
        assert [i for i, _ in items] == [0, 1, 2, 3, 4]
        pids = {p for _, p in items}
        assert pids and os.getpid() not in pids, "generator ran in-process"

    def test_streaming_remote_big_items_and_backpressure(self, shared):
        """Big yields stay on the agent as placeholders pulled on get();
        stream_max_backlog paces a fast remote producer."""
        stream = ray_tpu_torch.remote(udfs.gen_full).options(
            num_returns="streaming", stream_max_backlog=2,
            scheduling_strategy=_on(_remote_nodes(shared)[0])).remote(6, 200_000)  # 1.6 MB each
        seen = []
        for ref in stream:
            time.sleep(0.05)  # a slow consumer: the producer must be paced
            seen.append(float(ray_tpu_torch.get(ref, timeout=60)[0]))
        assert seen == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]

    def test_remote_actor_on_agent(self, shared):
        """An actor pinned to a remote node executes THERE, keeps state across
        ordered method calls, and dies cleanly on kill."""
        from ray_tpu_torch.core.actors import ActorState

        target = _remote_nodes(shared)[0]
        counter = ray_tpu_torch.remote(udfs.Counter).options(scheduling_strategy=_on(target)).remote(100)
        refs = [counter.add.remote(1) for _ in range(5)]
        assert ray_tpu_torch.get(refs, timeout=60) == [101, 102, 103, 104, 105]
        pid = ray_tpu_torch.get(counter.pid.remote(), timeout=60)
        assert pid != os.getpid() and _record(shared, target)["pid"] == pid
        assert counter.state() == ActorState.ALIVE
        ray_tpu_torch.kill(counter)
        with pytest.raises(ActorDiedError):
            ray_tpu_torch.get(counter.add.remote(1), timeout=60)
        assert counter.state() == ActorState.DEAD

    def test_nested_ref_borrowed_and_fetched_from_owner(self, shared):
        """An ObjectRef NESTED in a task argument crosses to the agent as a
        BORROWED reference: the agent pulls the value straight from the owner."""
        big = ray_tpu_torch.put(np.arange(50_000, dtype=np.float64))
        out = ray_tpu_torch.get(
            ray_tpu_torch.remote(num_cpus=1)(udfs.sum_nested).options(
                scheduling_strategy=_on(_remote_nodes(shared)[0])).remote({"ref": big}),
            timeout=60)
        assert out == float(np.arange(50_000, dtype=np.float64).sum())

    def test_borrow_pins_value_against_owner_gc(self, shared):
        """While an agent-held actor keeps a borrowed ref, the owner's last
        handle dying must NOT free the value (the borrow pin); it is reclaimed
        only after the borrower releases."""
        import gc

        holder = ray_tpu_torch.remote(udfs.Holder).options(
            scheduling_strategy=_on(_remote_nodes(shared)[0])).remote()
        ref = ray_tpu_torch.put(np.ones(10_000))
        oid = ref.object_id
        store = shared.runtime.object_store
        assert ray_tpu_torch.get(holder.hold.remote({"ref": ref}), timeout=60) is True
        deadline = time.monotonic() + 30
        while store.entry(oid).pin_count == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert store.entry(oid).pin_count >= 1, "borrow never registered"
        del ref
        gc.collect()
        entry = store.entry(oid)
        assert entry is not None and entry.value is not None  # the pin holds it
        assert ray_tpu_torch.get(holder.value_sum.remote(), timeout=60) == 10_000.0
        assert ray_tpu_torch.get(holder.release.remote(), timeout=60) is True
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            entry = store.entry(oid)
            if entry is None or entry.value is None:
                break
            time.sleep(0.05)
        assert entry is None or entry.value is None, "unborrow never reclaimed"

    def test_unimportable_function_stays_local_and_refuses_remote_pin(self, shared):
        """A function an agent could not import (the wire pickles by
        reference) runs only on the submitting node; pinning it hard to an
        agent raises TypeError at submission, naming the rule."""
        local = ray_tpu_torch.remote(num_cpus=1)(lambda: os.getpid())
        assert set(ray_tpu_torch.get([local.remote() for _ in range(4)], timeout=60)) == {os.getpid()}
        with pytest.raises(TypeError, match="module level"):
            local.options(scheduling_strategy=_on(_remote_nodes(shared)[0])).remote()

    def test_probe_agent_and_cli(self, shared, capsys):
        """health.probe_agent answers over the agent's RPC address; the CLI's
        `status` reports the live cluster (every node, agents included) and
        leaves this process's runtime up, and `--restore` without `--head`
        is refused with JAX's message."""
        from ray_tpu_torch.core.health import probe_agent

        assert all(probe_agent(n) for n in _remote_nodes(shared))
        assert probe_agent(shared.runtime.scheduler.head_node())
        from ray_tpu_torch.cli import main

        n = len(shared.runtime.scheduler.nodes())
        assert main(["--no-cuda", "status"]) == 0
        assert f"Nodes: {n} ({n} ALIVE)" in capsys.readouterr().out
        assert all(probe_agent(node) for node in _remote_nodes(shared))
        assert main(["start", "--address", shared.address, "--restore"]) == 2
        assert "--restore only applies to --head" in capsys.readouterr().err

    def test_jax_node_refuses_port_head(self, shared):
        """A JAX node dialing a port head fails at JAX's own protocol check:
        the port head advertises "torch-1", not JAX's 1."""
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        out = subprocess.run(
            [sys.executable, "-c",
             "import sys, ray_tpu\n"
             f"ray_tpu.init(address={shared.address!r}, num_cpus=1, detect_accelerators=False)\n"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "wire protocol torch-1" in out.stderr, out.stderr[-2000:]
        assert len(shared.runtime.scheduler.nodes()) == 3  # nothing joined
