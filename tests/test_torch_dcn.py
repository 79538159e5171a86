"""The port's cross-slice (DCN) replicator against the JAX package.

The 4 cases of `tests/test_dcn.py` run on the port with their bounds
unchanged (a pytree replicated to a peer agent while the caller goes on,
the latest snapshot superseding a queued one, a missing replica, int8
quantization cutting the wire bytes). Then the port's own cases:
`_quantize_leaf` / `_dequantize_leaf` bit for bit against JAX's (f32 and
f16; sizes below, at and above 4096 elements; padding to the 512-element
block), a bf16 tensor leaf's round trip (exact, and int8 through f32 back
to bf16), and the snapshot taken at the call: a tensor written in place
right after `replicate_async` still replicates as it was at the call. The
peer's probes live in `torch_cluster_udfs.py` (agents import them by
reference). One cluster serves the file: no test kills a node.
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu.parallel import dcn as jdcn
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.scheduler import NodeAffinitySchedulingStrategy
from ray_tpu_torch.parallel import CrossSliceReplicator, fetch_replica
from ray_tpu_torch.parallel import dcn as tdcn


@pytest.fixture(scope="module")
def cluster():
    before = torch_process_udfs.live_children()
    c = Cluster(head_node_args={"num_cpus": 2, "_system_config": {"node_heartbeat_s": 0.2}})
    c.add_node(num_cpus=2, system_config={"node_heartbeat_s": 0.2})
    c.wait_for_nodes(2)
    yield c
    c.shutdown()
    cfg.reset()
    assert torch_process_udfs.wait_no_children(before, timeout=30) == []


def _peer(cluster):
    return next(n for n in cluster.runtime.scheduler.nodes() if n.is_remote)


def _on_peer(cluster, fn, *args):
    task = ray_tpu_torch.remote(num_cpus=1)(fn).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(_peer(cluster).node_id))
    return ray_tpu_torch.get(task.remote(*args), timeout=60)


def test_replicates_pytree_to_peer_and_overlaps(cluster):
    state = {"params": {"w": np.arange(500_000, dtype=np.float32),
                        "b": np.ones(128, dtype=np.float32)},
             "step": 7}
    rep = CrossSliceReplicator(_peer(cluster).agent_addr)
    try:
        t0 = time.perf_counter()
        rep.replicate_async("trainstate", state)
        submit_latency = time.perf_counter() - t0
        # the call must not block on the 2 MB transfer: compute keeps going
        assert submit_latency < 0.05, submit_latency
        assert rep.wait(timeout=60)
        assert rep.stats["replicated"] == 1
        assert rep.stats["bytes"] >= 2_000_000
        # the peer resolves the replica from its own store
        replica = _on_peer(cluster, udfs.replica, "trainstate")
        assert float(replica["params"]["w"].sum()) == float(
            np.arange(500_000, dtype=np.float32).sum())
        assert replica["step"] == 7
    finally:
        rep.close()


def test_latest_snapshot_supersedes_queued(cluster):
    """The mirror wants the latest state: snapshots accepted while a
    transfer is in flight replace a queued one."""
    rep = CrossSliceReplicator(_peer(cluster).agent_addr)
    try:
        big = np.ones(2_000_000, dtype=np.float64)  # 16 MB: takes a beat
        for version in range(6):
            rep.replicate_async("s", {"v": version, "payload": big})
        assert rep.wait(timeout=120)
        assert rep.stats["replicated"] < 6
        assert rep.stats["superseded"] >= 1
        assert _on_peer(cluster, udfs.replica_field, "s", "v") == 5
    finally:
        rep.close()


def test_fetch_replica_missing_raises(cluster):
    with pytest.raises(KeyError, match="no replica"):
        fetch_replica("never-sent", runtime=cluster.runtime)


def test_quantized_replication_cuts_wire_bytes(cluster):
    """quantize="int8" block-quantizes float leaves before the push (~4x
    fewer wire bytes) and fetch_replica dequantizes; small and non-float
    leaves pass through exact."""
    rng = np.random.default_rng(0)
    state = {"params": {"w": rng.standard_normal(500_000).astype(np.float32)},
             "ids": np.arange(100_000, dtype=np.int32),  # non-float: exact
             "small": rng.standard_normal(16).astype(np.float32),  # tiny: exact
             "step": 11}
    rep = CrossSliceReplicator(_peer(cluster).agent_addr, quantize="int8")
    try:
        rep.replicate_async("qstate", state)
        assert rep.wait(timeout=60)
        assert rep.stats["replicated"] == 1
        assert rep.stats["raw_bytes"] >= 2_400_000
        assert rep.stats["bytes"] < rep.stats["raw_bytes"] * 0.45
        replica = _on_peer(cluster, udfs.replica, "qstate")
        w = replica["params"]["w"]
        assert w.shape == (500_000,) and w.dtype == np.float32
        denom = max(np.abs(state["params"]["w"]).max(), 1e-9)
        assert np.abs(w - state["params"]["w"]).max() / denom < 0.005
        assert replica["ids"][-1] == 99_999
        np.testing.assert_array_equal(replica["small"], state["small"])
        assert replica["step"] == 11
    finally:
        rep.close()


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("size", [100, 4095, 4096, 4097, 5000, 65_536])
def test_quantizer_matches_jax_bit_for_bit(dtype, size):
    """Below 4096 elements a leaf passes through; at and above, the
    values, scales (blocks of 512, the last padded with zeros), shape and
    dtype equal JAX's, and so does the dequantized leaf."""
    rng = np.random.default_rng(size)
    x = (rng.standard_normal(size) * rng.uniform(0.1, 50.0)).astype(dtype).reshape(-1, 1)
    x[: min(512, size) // 2] = 0.0  # an all-zero block (scale 1) where the leaf is big
    tq, jq = tdcn._quantize_leaf(x), jdcn._quantize_leaf(x)
    if size < 4096:
        assert tq is x and jq is x
        return
    assert tq.keys() == jq.keys()
    for key in ("values", "scales"):
        assert tq[key].dtype == jq[key].dtype and tq[key].shape == jq[key].shape
        assert tq[key].tobytes() == jq[key].tobytes()
    assert (tq["shape"], tq["dtype"]) == (jq["shape"], jq["dtype"])
    td, jd = tdcn._dequantize_leaf(tq), jdcn._dequantize_leaf(jq)
    assert td.dtype == jd.dtype == dtype and td.shape == x.shape
    assert td.tobytes() == jd.tobytes()
    # a non-float leaf and a plain value pass through both
    ids = np.arange(10_000, dtype=np.int64)
    assert tdcn._quantize_leaf(ids) is ids and jdcn._quantize_leaf(ids) is ids
    assert tdcn._quantize_leaf(3.5) == jdcn._quantize_leaf(3.5) == 3.5


def test_bf16_tensor_leaf_round_trip(cluster):
    """A bf16 tensor replicates exactly as a CPU bf16 tensor; under int8 it
    goes through f32 and comes back as bf16 within JAX's bound, and it
    quantizes to what JAX quantizes for its f32 values."""
    gen = torch.Generator().manual_seed(3)
    t = torch.randn(300, 64, generator=gen).to(torch.bfloat16)
    small = torch.randn(8, generator=gen).to(torch.bfloat16)
    q = tdcn._quantize_leaf(t)
    jq = jdcn._quantize_leaf(t.float().numpy())
    assert q["torch_dtype"] == "bfloat16" and q["values"].tobytes() == jq["values"].tobytes()
    for mode, key in ((None, "bf16-exact"), ("int8", "bf16-q8")):
        rep = CrossSliceReplicator(_peer(cluster).agent_addr, quantize=mode)
        try:
            rep.replicate_async(key, {"t": t, "small": small})
            assert rep.wait(timeout=60)
        finally:
            rep.close()
        back = _on_peer(cluster, udfs.replica, key)
        assert back["t"].dtype == torch.bfloat16 and back["t"].shape == t.shape
        assert back["t"].device.type == "cpu"
        assert torch.equal(back["small"], small)
        if mode is None:
            assert torch.equal(back["t"], t)
        else:
            rel = float((back["t"].float() - t.float()).abs().max() / t.float().abs().max())
            assert rel < 0.005 + 2 ** -8  # JAX's bound, plus bf16's own rounding


def test_tensor_written_in_place_replicates_as_at_the_call(cluster):
    """The snapshot is taken at the call: an in-place step right after
    replicate_async (as an optimizer's) never reaches the replica, whose
    leaves equal the state at the call bit for bit, as CPU tensors with
    the leaves' dtypes, inside the port's dataclasses."""
    from ray_tpu_torch.train.lm import AdamWState, TrainState

    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(512, 512, generator=gen), "b": torch.zeros(512)}
    state = TrainState(step=4, params=params,
                       opt_state=AdamWState(count=4, mu={k: v.clone() for k, v in params.items()},
                                            nu={k: v.clone() for k, v in params.items()}))
    expected = udfs.leaf_digests(state)
    rep = CrossSliceReplicator(_peer(cluster).agent_addr)
    try:
        rep.replicate_async("inplace", state)
        with torch.no_grad():  # the step writes every leaf in place at once
            for tree in (state.params, state.opt_state.mu, state.opt_state.nu):
                for v in tree.values():
                    v.add_(1.0)
        state.step += 1
        assert rep.wait(timeout=60)
    finally:
        rep.close()
    got = _on_peer(cluster, udfs.replica_digests, "inplace")
    assert got["digests"] == expected
    assert got["devices"] == ["cpu"]
    assert udfs.leaf_digests(state) != expected  # the caller's state did move on
