"""The port's cluster mode, part 2: every case of
`tests/test_cluster_actor_restart.py` (actors restarting on a surviving
node), `tests/test_cluster_locality.py` (big arguments shipped as refs and
pulled where the task runs, peer to peer, and the default policy's
argument locality) and `tests/test_cluster_admission.py` (an agent's own
ledger admits against two drivers, bounces overflow, parks completions an
unreachable owner could not take) run on the port; and the slice's parity
test: a tiny Llama `LLMServer` hosted on a node agent, its weights
converted from JAX's init and passed as an ObjectRef (pulled over the
chunked transfer), gives the greedy tokens of JAX's `PagedLLMEngine`.

Tests that kill a node own their cluster; the locality tests share one.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.exceptions import ActorDiedError
from ray_tpu_torch.core.object_store import Tier
from ray_tpu_torch.core.scheduler import NodeAffinitySchedulingStrategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENT = {"node_heartbeat_s": 0.2}


def _make(head_cpus, stale_s, agents):
    """A head (in-process) and agents [(num_cpus, resources, extra system
    config), ...]."""
    c = Cluster(head_node_args={"num_cpus": head_cpus, "_system_config": {
        "node_stale_s": stale_s, "node_heartbeat_s": 0.2}})
    for cpus, res, extra in agents:
        c.add_node(num_cpus=cpus, resources=res, system_config={**AGENT, **(extra or {})})
    c.wait_for_nodes(1 + len(agents))
    return c


@pytest.fixture
def cluster_of():
    """cluster_of(head_cpus, stale_s, agents) -> a cluster torn down (and
    its agents reaped) after the test."""
    made = []
    before = torch_process_udfs.live_children()

    def make(*args):
        made.append(_make(*args))
        return made[-1]

    yield make
    for c in made:
        c.shutdown()
    cfg.reset()  # _system_config overrides must not leak across tests
    assert torch_process_udfs.wait_no_children(before) == [], "an agent outlived its cluster"


def _remote_nodes(c):
    return [n for n in c.runtime.scheduler.nodes() if n.is_remote]


def _on(node):
    return NodeAffinitySchedulingStrategy(node.node_id)


def _pid_of(c, node):
    return next(rec["pid"] for rec in c.runtime.cluster.nodes()
                if rec["node_id"] == node.node_id.hex())


def _agent_handle_for(c, node):
    pid = _pid_of(c, node)
    return next(h for h in c._nodes if h.pid == pid)


def _until(fn, timeout=60.0, every=0.2, retry=(ActorDiedError,)):
    """fn() once it stops raising `retry` (a death racing a restart)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return fn()
        except retry:
            time.sleep(every)
    return None


SLOTS = [(2, {"slot": 1}, None), (2, {"slot": 1}, None)]


# ------------------------------------------------------------ actor restart


def test_actor_restarts_on_surviving_node(cluster_of):
    """Kill the hosting agent: the next call succeeds on the other node,
    with state rebuilt from __init__, and the named directory repoints."""
    c = cluster_of(1, 2.5, SLOTS)
    target = _remote_nodes(c)[0]
    actor = ray_tpu_torch.remote(num_cpus=1, resources={"slot": 1}, max_restarts=1)(
        udfs.Survivor).options(name="survivor", scheduling_strategy=_on(target)).remote()
    pid1, calls = ray_tpu_torch.get(actor.bump.remote(), timeout=60)
    assert calls == 1
    c.remove_node(_agent_handle_for(c, target), allow_graceful=False)
    got = _until(lambda: ray_tpu_torch.get(actor.bump.remote(), timeout=60))
    assert got is not None, "actor never came back"
    pid2, calls2 = got
    assert pid2 != pid1 and calls2 == 1, "a restart rebuilds from __init__"
    assert pid2 in {rec["pid"] for rec in c.runtime.cluster.nodes()}
    again = ray_tpu_torch.get_actor("survivor")
    assert ray_tpu_torch.get(again.bump.remote(), timeout=60)[0] == pid2


def test_zero_restart_actor_dies_cleanly(cluster_of):
    c = cluster_of(1, 2.5, SLOTS)
    target = _remote_nodes(c)[1]
    actor = ray_tpu_torch.remote(num_cpus=1)(udfs.Mortal).options(
        scheduling_strategy=_on(target)).remote()
    ray_tpu_torch.get(actor.ping.remote(), timeout=60)
    c.remove_node(_agent_handle_for(c, target), allow_graceful=False)
    with pytest.raises(ActorDiedError):
        deadline = time.monotonic() + 60  # max_restarts defaults to 0
        while True:
            ray_tpu_torch.get(actor.ping.remote(), timeout=60)
            assert time.monotonic() < deadline
            time.sleep(0.2)


def test_inflight_call_fails_but_handle_survives(cluster_of):
    """An in-flight call on the dying node fails (no replay), yet the
    restarted actor serves the next calls."""
    c = cluster_of(1, 2.5, SLOTS)
    target = _remote_nodes(c)[0]
    actor = ray_tpu_torch.remote(num_cpus=1, resources={"slot": 1}, max_restarts=2)(
        udfs.Slow).options(scheduling_strategy=_on(target)).remote()
    assert ray_tpu_torch.get(actor.quick.remote(), timeout=60) != os.getpid()
    pending = actor.nap.remote(30)
    time.sleep(0.5)  # let it land on the agent
    c.remove_node(_agent_handle_for(c, target), allow_graceful=False)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(pending, timeout=60)
    pid = _until(lambda: ray_tpu_torch.get(actor.quick.remote(), timeout=60))
    assert pid is not None and pid != os.getpid()


# --------------------------------------------------------------- locality


@pytest.fixture(scope="class")
def loc():
    before = torch_process_udfs.live_children()
    c = _make(1, 5.0, [(2, None, None), (2, None, None)])
    yield c
    c.shutdown()
    cfg.reset()
    assert torch_process_udfs.wait_no_children(before) == []


def _sealed(c, ref):
    store = c.runtime.object_store
    deadline = time.monotonic() + 60
    while not store.is_ready(ref.object_id) and time.monotonic() < deadline:
        time.sleep(0.02)
    return store.entry(ref.object_id)


class TestLocality:
    """Big arguments ship as refs and are pulled where the task runs."""

    def test_peer_to_peer_arg_transfer_owner_never_materializes(self, loc):
        """A big result living on agent A, passed to a task pinned to agent
        B: B pulls the bytes from A, and the owner's entry STAYS a remote
        placeholder — the bytes never routed through the owner."""
        a, b = _remote_nodes(loc)
        ref = ray_tpu_torch.remote(num_cpus=1)(udfs.arange_f64).options(
            scheduling_strategy=_on(a)).remote(2_000_000)  # 16 MB
        entry = _sealed(loc, ref)
        assert entry.tier == Tier.REMOTE
        assert entry.nbytes == 16_000_000  # the producer reported the size
        out = ray_tpu_torch.get(ray_tpu_torch.remote(num_cpus=1)(udfs.item).options(
            scheduling_strategy=_on(b)).remote(ref, 1_234_567), timeout=120)
        assert out == 1_234_567.0
        assert loc.runtime.object_store.entry(ref.object_id).tier == Tier.REMOTE

    def test_big_local_arg_ships_as_ref_and_resolves_on_agent(self, loc):
        """An owner-held arg above remote_inline_max_bytes ships as a ref;
        the agent pulls it over the chunked plane."""
        big = ray_tpu_torch.put(np.ones(1_500_000, dtype=np.float64))  # 12 MB
        out = ray_tpu_torch.get(ray_tpu_torch.remote(num_cpus=1)(udfs.total).options(
            scheduling_strategy=_on(_remote_nodes(loc)[0])).remote(big), timeout=120)
        assert out == 1_500_000.0

    def test_default_strategy_prefers_arg_locality(self, loc):
        """With a free choice, a task consuming a big remote-located arg
        lands on the node already holding it."""
        a = _remote_nodes(loc)[0]
        ref = ray_tpu_torch.remote(num_cpus=1)(udfs.arange_f64).options(
            scheduling_strategy=_on(a)).remote(2_000_000)
        assert _sealed(loc, ref).tier == Tier.REMOTE
        consume = ray_tpu_torch.remote(num_cpus=1)(udfs.pid_of_arg)
        # SEQUENTIALLY, so A always has a free slot
        pids = [ray_tpu_torch.get(consume.remote(ref), timeout=120) for _ in range(4)]
        assert all(p == _pid_of(loc, a) for p in pids), (pids, _pid_of(loc, a))


# -------------------------------------------------------------- admission


def _max_overlap(log_path):
    events = []
    with open(log_path) as f:
        for line in f:
            kind, ns = line.split()
            events.append((int(ns), 1 if kind == "S" else -1))
    events.sort()
    cur = peak = 0
    for _, delta in events:
        cur += delta
        peak = max(peak, cur)
    return peak


def _wait_for(path, proc, timeout=120):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        assert proc.poll() is None, f"second driver exited:\n{proc.communicate()[0]}"
        assert time.monotonic() < deadline, f"never appeared: {path}"
        time.sleep(0.05)


_SECOND_DRIVER = textwrap.dedent("""
    import sys
    import time
    import ray_tpu_torch
    import torch_cluster_udfs as udfs

    address, resource, n, ready_path = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    log_path = sys.argv[5] if len(sys.argv) > 5 else None
    ray_tpu_torch.init(address=address, num_cpus=0, detect_accelerators=False)
    deadline = time.monotonic() + 60
    while ray_tpu_torch.cluster_resources().get(resource, 0) < 2:
        assert time.monotonic() < deadline, resource + " node never discovered"
        time.sleep(0.1)
    open(ready_path, "w").write("ready")  # both drivers flood together
    if log_path:
        f = ray_tpu_torch.remote(num_cpus=0, resources={resource: 1})(udfs.flood)
        pids = ray_tpu_torch.get([f.remote(log_path, 0.3) for _ in range(n)], timeout=180)
        assert len(pids) == n
    else:
        f = ray_tpu_torch.remote(num_cpus=0, resources={resource: 1})(udfs.drip)
        outs = ray_tpu_torch.get([f.remote(i) for i in range(n)], timeout=180)
        assert sorted(outs) == list(range(n))
    ray_tpu_torch.shutdown()
    print("SECOND-DRIVER-OK")
""")


def _second_driver(c, resource, n, ready_path, log_path=None):
    args = [sys.executable, "-c", _SECOND_DRIVER, c.address, resource, str(n), ready_path]
    return subprocess.Popen(args + ([log_path] if log_path else []), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


SINK = [(2, {"sink": 2}, None)]


def test_two_driver_flood_respects_agent_ledger(cluster_of):
    """Two drivers flooding one agent: concurrent executions never exceed
    its sink capacity (2) — the agent's OWN ledger admits, not the
    drivers' optimistic views."""
    c = cluster_of(1, 5.0, SINK)
    fd, log_path = tempfile.mkstemp(prefix="ray_tpu_torch_flood_", suffix=".log")
    os.close(fd)
    ready_path = log_path + ".ready"
    n_each = 6
    second = _second_driver(c, "sink", n_each, ready_path, log_path)
    try:
        _wait_for(ready_path, second)
        flood = ray_tpu_torch.remote(num_cpus=0, resources={"sink": 1})(udfs.flood)
        pids = ray_tpu_torch.get([flood.remote(log_path, 0.3) for _ in range(n_each)],
                                 timeout=180)
        out, _ = second.communicate(timeout=180)
    finally:
        if second.poll() is None:
            second.kill()
            second.wait()
    assert "SECOND-DRIVER-OK" in out, f"second driver failed:\n{out}"
    assert len(pids) == n_each
    assert sum(1 for _ in open(log_path)) == 2 * 2 * n_each, "lost log events"
    peak = _max_overlap(log_path)
    assert peak <= 2, f"the agent ran {peak} sink tasks at once with capacity 2"
    os.unlink(log_path)
    os.unlink(ready_path)


def test_admission_queue_overflow_bounces_and_completes(cluster_of):
    """Two drivers into a capacity-2 agent with a 1-deep admission queue:
    overflowing dispatches bounce ("busy") to their owner, which requeues;
    everything completes exactly once and the agent counts the bounces."""
    c = cluster_of(1, 5.0, [(1, {"drip": 2}, {"agent_admission_queue": 1})])
    fd, ready_path = tempfile.mkstemp(prefix="ray_tpu_torch_drip_")
    os.close(fd)
    os.unlink(ready_path)
    n_each = 6
    second = _second_driver(c, "drip", n_each, ready_path)
    try:
        _wait_for(ready_path, second)
        drip = ray_tpu_torch.remote(num_cpus=0, resources={"drip": 1})(udfs.drip)
        outs = ray_tpu_torch.get([drip.remote(i) for i in range(n_each)], timeout=180)
        out, _ = second.communicate(timeout=180)
    finally:
        if second.poll() is None:
            second.kill()
            second.wait()
    assert "SECOND-DRIVER-OK" in out, f"second driver failed:\n{out}"
    assert sorted(outs) == list(range(n_each))
    stats = ray_tpu_torch.get(ray_tpu_torch.remote(num_cpus=0, resources={"drip": 1})(
        udfs.agent_stats).remote(), timeout=60)
    assert stats["bounced"] >= 1, f"no bounces recorded: {stats}"
    assert stats["queued"] >= 1, f"nothing ever queued: {stats}"
    os.unlink(ready_path)


def test_parked_result_recovery_after_owner_outage(cluster_of):
    """The owner's node server goes dark past the agent's delivery budget:
    the agent PARKS the completion and the owner's poll loop reclaims it —
    get() completes instead of hanging."""
    from ray_tpu_torch.core.rpc import RpcServer

    c = cluster_of(1, 5.0, [(1, {"park": 1}, {"result_delivery_attempts": 2})])
    cfg.set(pending_task_poll_s=2.0)
    ctx = c.runtime.cluster
    ref = ray_tpu_torch.remote(num_cpus=0, resources={"park": 1})(udfs.slow_answer).remote()
    time.sleep(0.3)  # the dispatch reaches the agent
    # the owner goes dark: its node server stops (heartbeats ride the GCS
    # server, which stays up — the node is alive, just unreachable)
    inner = ctx.server._server
    host, port = inner.address
    inner.stop()
    time.sleep(4.0)  # outlives 2 delivery attempts -> parked
    ctx.server._server = RpcServer(inner.handlers, host=host, port=port, token=c.token)
    assert ray_tpu_torch.get(ref, timeout=60) == 42


def test_foreign_get_gives_up_without_location():
    """A cluster-mode get() on a ref whose producer never registers a
    location ends in ObjectLostError after the bounded directory poll."""
    from ray_tpu_torch.core.exceptions import ObjectLostError
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_store import ObjectStore

    cfg.set(foreign_locate_max_s=0.4)
    try:
        store = ObjectStore()
        store.set_cluster_hooks(fetch_remote=lambda oid, addr: None, locate=lambda oid: None)
        t0 = time.monotonic()
        with pytest.raises(ObjectLostError):
            store.get(ObjectID.from_random(), timeout=None)
        assert time.monotonic() - t0 < 5.0
    finally:
        cfg.reset("foreign_locate_max_s")


# ----------------------------------------------------------------- parity


def test_tiny_llama_actor_on_agent_matches_jax_engine(cluster_of):
    """The slice's parity test: a tiny Llama (f32, 2 layers) LLMServer
    hosted on a node agent, its weights converted from JAX's init and
    passed as an ObjectRef (the agent pulls them from this process over
    the chunked transfer, a borrowed reference), gives the greedy tokens
    of JAX's PagedLLMEngine on the same weights and prompts."""
    import jax
    import torch

    from ray_tpu import models as jmodels
    from ray_tpu.serve.llm import paged as jpaged
    from ray_tpu.serve.llm.paged_engine import PagedEngineConfig as JEngineConfig
    from ray_tpu.serve.llm.paged_engine import PagedLLMEngine as JEngine
    from ray_tpu_torch import models as tmodels
    from ray_tpu_torch.serve.llm import paged as tpaged

    pc = dict(page_size=8, num_pages=64, max_pages_per_slot=8, chunk_pages=2)
    prompts = [[int(t) for t in np.random.default_rng(3).integers(1, 200, size=41)],
               [1, 2, 3], [9, 8], [30, 31, 32, 33], [4]]
    jconfig = jmodels.get_config("llama-tiny").replace(n_layers=2)
    jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(0))
    tconfig = tmodels.get_config("llama-tiny").replace(n_layers=2)
    assert tconfig.param_dtype == torch.float32
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams), tconfig,
                                        device="cpu")
    engine = JEngine(jconfig, jparams, JEngineConfig(max_slots=4, paged=jpaged.PagedConfig(**pc)))
    try:
        streams = [engine.submit(p, max_tokens=6) for p in prompts]
        want = [s.result(timeout=120) for s in streams]
    finally:
        engine.shutdown()

    c = cluster_of(1, 5.0, [(2, None, None)])
    agent = _remote_nodes(c)[0]
    ref = ray_tpu_torch.put(tparams)
    llm = ray_tpu_torch.remote(num_cpus=1)(udfs.TinyLLM).options(
        scheduling_strategy=_on(agent)).remote(
            tconfig, {"ref": ref}, {"max_slots": 4, "paged": tpaged.PagedConfig(**pc)})
    assert ray_tpu_torch.get(llm.pid.remote(), timeout=120) == _pid_of(c, agent)
    got = ray_tpu_torch.get(llm.generate.remote(prompts, 6), timeout=120)
    assert got == want
    assert ray_tpu_torch.get(llm.shutdown.remote(), timeout=60)
