"""The port's data plane ON a cluster: every case of
`tests/test_data_cluster.py` run on the port — read and map tasks spill
to node agents, blocks flow as refs pulled where they are consumed, a
stateful actor pool places across nodes, a node killed mid-ingest costs
nothing but lineage re-execution, and map tasks follow their input
block's node.

The udfs live in the root module `torch_cluster_udfs.py` (an agent
imports what it runs by reference; a lambda would stay on the submitting
node).
"""

import functools
import os
import tempfile
import time

import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu_torch import data as rdata
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import cfg


def _cluster(sysconf):
    before = torch_process_udfs.live_children()
    c = Cluster(head_node_args={"num_cpus": 1,
                                "_system_config": {"node_stale_s": 5.0, **sysconf}})
    try:
        c.add_node(num_cpus=2, num_gpus=0, system_config=sysconf)
        c.add_node(num_cpus=2, num_gpus=0, system_config=sysconf)
        c.wait_for_nodes(3)
    except BaseException:
        c.shutdown()
        cfg.reset()
        raise
    return c, before


def _teardown(c, before):
    c.shutdown()
    cfg.reset()
    assert torch_process_udfs.wait_no_children(before) == [], "an agent outlived its cluster"


@pytest.fixture(scope="class")
def cluster():
    """A head (1 CPU, in this process) + 2 agents (2 CPUs each)."""
    c, before = _cluster({"node_heartbeat_s": 0.2})
    yield c
    _teardown(c, before)


@pytest.fixture
def pinned_cluster():
    """Like `cluster`, with the remote-inline cutoff forced tiny so task
    results STAY in their producer node's store."""
    c, before = _cluster({"node_heartbeat_s": 0.2, "remote_inline_max_bytes": 64})
    yield c
    _teardown(c, before)


class TestDataOnCluster:
    def test_map_batches_spans_agents(self, cluster):
        """A 12-block map pipeline on a 3-node cluster: results are exact
        and the map tasks ran in >= 2 distinct agent processes."""
        fd, log = tempfile.mkstemp(prefix="ray_tpu_torch_datapids_")
        os.close(fd)
        ctx = rdata.DataContext.get_current()
        old_prefetch = ctx.prefetch_blocks
        ctx.prefetch_blocks = 8  # enough tasks in flight to need both agents
        try:
            # a partial of a module-level udf pickles by reference; the
            # wrapper's name is the task's name
            udf = functools.update_wrapper(
                functools.partial(udfs.square_and_log, log_path=log), udfs.square_and_log)
            ds = rdata.range(1200, num_blocks=12).map_batches(udf)
            total = sum(int(r) for r in ds.take(2000))
        finally:
            ctx.prefetch_blocks = old_prefetch
        assert total == sum(i * i for i in range(1200))
        with open(log) as f:
            pids = {int(line) for line in f if line.strip()}
        os.unlink(log)
        agent_pids = {rec["pid"] for rec in cluster.runtime.cluster.nodes() if not rec["is_head"]}
        assert len(pids & agent_pids) >= 2, f"map tasks used {pids}, agents are {agent_pids}"

    def test_actor_pool_udf_on_cluster(self, cluster):
        """Stateful ActorPoolStrategy udfs place across the cluster too."""
        ds = rdata.range(100, num_blocks=4).map_batches(
            udfs.AddOffset, compute=rdata.ActorPoolStrategy(size=2),
            fn_constructor_args=(1000,))
        assert sorted(int(r) for r in ds.take(200)) == [i + 1000 for i in range(100)]

    def test_cluster_ingest_locality_routing(self, cluster):
        """Map tasks carry a locality hint for the node holding their input
        block; on an idle cluster most land there (a soft preference, so
        the bar is a majority, and three independent pipelines get to
        clear it: a just-started cluster's first round can lose it to
        discovery races)."""
        stats = None
        best = 0.0
        for _ in range(3):
            ds = rdata.range(400, num_blocks=8).map_batches(udfs.add_one_items)
            total = sum(int(r) for r in ds.take(500))
            assert total == sum(i + 1 for i in range(400))
            stats = ds.stats()
            assert stats["locality_total"] > 0
            best = max(best, stats["locality_hit_rate"])
            if best >= 0.5:
                break
        assert best >= 0.5, stats


def test_kill_node_mid_ingest_exactly_once(pinned_cluster):
    """Blocks live in their producer node's store; SIGKILL that node
    before the consumer fetches, and the lost blocks re-execute through
    lineage: the consumer still sees every row exactly once, and the
    store counts the reconstructions."""
    cluster = pinned_cluster
    ctx = rdata.DataContext.get_current()
    old_prefetch = ctx.prefetch_blocks
    ctx.prefetch_blocks = 16  # submit the whole 12-block plan up front
    try:
        ds = rdata.range(600, num_blocks=12).map_batches(udfs.double_items)
        refs = list(ds.iter_block_refs())
        assert len(refs) == 12
        ready, pending = ray_tpu_torch.wait(refs, num_returns=12, timeout=120)
        assert not pending
        victim = cluster._nodes[0]
        cluster.remove_node(victim, allow_graceful=False)
        deadline = time.monotonic() + 30
        while len(cluster.runtime.scheduler.nodes()) > 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        blocks = ray_tpu_torch.get(refs, timeout=120)
        rows = sorted(int(r) for b in blocks for r in b["item"])
        assert rows == [i * 2 for i in range(600)], "rows not exactly-once"
        assert cluster.runtime.object_store.stats["reconstructions"] > 0, (
            "killing a producer node should have forced lineage re-execution")
    finally:
        ctx.prefetch_blocks = old_prefetch
