"""The port's multi-process gang (`train/multihost.py`) against the JAX
package on the CPU.

JAX's own two-process test is skipped on the CPU (XLA has no
multi-process CPU backend: tests/test_multihost.py:81-85), so the
reference is JAX's single-process dp=2 run of the same program on two of
the 8 virtual CPU devices of tests/conftest.py. The port runs it in two
spawned processes over gloo, driven by `TrainController` through
`group_factory=MultihostWorkerGroup`, from JAX's initial state carried
over as numpy: the losses agree at atol = rtol = 1e-4 (f32 through
llama-tiny's 4 layers, as tests/test_torch_train.py holds the step).
Rank functions are module-level (ranks import this module by name: the
worker protocol pickles with the standard `pickle`), and JAX is imported
inside the tests only. Every wait has a timeout: 120 s for the ranks'
collectives and start-up, 60 s for a poll loop.
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from ray_tpu_torch.core.worker_pool import WorkerCrashedError
from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TrainController
from ray_tpu_torch.train.multihost import MultihostWorkerGroup

N = 2
STEPS = 3
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def _global_tokens(vocab):
    """JAX's multihost test batch: the global (8, 33) batch of arange."""
    return np.arange(8 * 33, dtype=np.int32).reshape(8, 33) % vocab


class _Stream:
    """The global batch as one flat block, `STEPS` times (lm_batch_iterator
    packs it back into the same (8, 33) windows)."""

    def __init__(self, tokens):
        self.tokens = tokens

    def iter_blocks(self):
        for _ in range(STEPS):
            yield {"tokens": self.tokens.reshape(-1)}


# ------------------------------------------------------------ rank programs


def _dp_program(config):
    """A rank of the controller-driven gang: llama-tiny at dp=2 from JAX's
    initial state, fed by lm_batch_iterator(sharding=), reporting each
    step's loss; then the per-rank batch placement of iter_torch_batches;
    then a checkpoint drill of an int8 + sharded-update LMTrainer."""
    import torch.distributed as dist

    from ray_tpu_torch.data import from_numpy, lm_batch_iterator
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.parallel import MeshSpec, build_mesh, data_sharding
    from ray_tpu_torch.train import (
        CheckpointConfig, LMTrainer, default_optimizer, make_train_step, report,
        train_state_from_numpy, tree_leaves,
    )

    torch.set_num_threads(1)
    rank = dist.get_rank()
    model = get_config("llama-tiny")
    mesh = build_mesh(MeshSpec(dp=N), ["cpu"])
    sharding = data_sharding(mesh)
    opt = default_optimizer(1e-3, total_steps=10)
    state = train_state_from_numpy(config["init"], model, mesh=mesh)
    step = make_train_step(model, opt, mesh=mesh)
    rows = []
    for batch in lm_batch_iterator(_Stream(config["tokens"]), 32, 8, sharding=sharding):
        rows.append(batch["tokens"].tolist())
        state, metrics = step(state, batch)
        report({"loss": float(metrics["loss"]), "num_tokens": float(metrics["num_tokens"])})

    ds = from_numpy({"x": np.arange(32).reshape(16, 2)}, num_blocks=2)
    placed = [b["x"].tolist() for b in ds.iter_torch_batches(8, device="cpu", sharding=sharding)]

    ckpt = CheckpointConfig(checkpoint_dir=config["ckpt_dir"], checkpoint_every=2, async_save=True)

    def trainer():
        return LMTrainer(get_config("gpt2-tiny"), mesh_spec=MeshSpec(dp=N), device="cpu",
                         learning_rate=1e-3, total_steps=10, checkpoint_config=ckpt,
                         dp_allreduce_dtype="int8", dp_shard_update=True)

    first = trainer()
    batches = [{"tokens": np.random.default_rng(i).integers(0, 256, (8, 17)).astype(np.int32)}
               for i in range(2)]
    reports = []
    first.train(batches, num_steps=2, report_fn=reports.append)
    second = trainer()
    restored = second.maybe_restore()
    pairs = [(first.state.params, second.state.params), (first.state.ef, second.state.ef),
             (first.state.opt_state.mu, second.state.opt_state.mu),
             (first.state.opt_state.nu, second.state.opt_state.nu)]
    bitwise = all(torch.equal(a, b) for x, y in pairs for a, b in zip(tree_leaves(x), tree_leaves(y)))
    report({"rank_rows": rows, "placed": placed, "restored": restored, "bitwise": bitwise,
            "count": second.state.opt_state.count,
            "dp_sync_mode": first.dp_sync_mode, "dp_sync_bytes": first.dp_sync_bytes,
            "n_params": first.num_params, "dp_sync_s": reports[-1]["dp_sync_s"],
            "report_bytes": reports[-1].get("dp_sync_bytes"),
            "sampled_dp_sync": [(rec["buckets"]["dp_sync"], rec["buckets"]["fwd_bwd_compute"])
                                for r in reports for rec in r.get("_steplog", [])],
            "rank": rank})
    return rank


def _report_three(config):
    from ray_tpu_torch.train import report

    for i in range(3):
        report({"i": i})
    return "done"


def _exit_hard(config):
    os._exit(9)


def _rank1_exits(config):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        os._exit(9)
    return "rank 0 done"


# ------------------------------------------------------------------ tests


def _jax_dp2_run():
    """JAX's dp=2 run on two devices of this process: its initial state (as
    numpy namespaces) and its losses."""
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


def _rank_reports(report_dir, rank):
    with open(os.path.join(report_dir, f"reports_rank{rank}.jsonl")) as f:
        return [json.loads(line)["metrics"] for line in f]


def test_two_process_gang_matches_jax_dp2_run(tmp_path):
    """TrainController drives a MultihostWorkerGroup of two gloo ranks:
    the losses rank 0 reports equal JAX's single-process dp=2 run; each
    rank packed the global batch and placed its own rows (JAX's
    make_array_from_process_local_data split), and so did
    iter_torch_batches(sharding=); an int8 + sharded-update LMTrainer's
    checkpoint, saved per rank and restored by a second trainer in each
    rank, is bitwise equal, with the layout in the step's index."""
    from ray_tpu.core.config import cfg as jcfg
    from ray_tpu.parallel.collectives import dp_sync_bytes as jdp_sync_bytes
    from ray_tpu_torch.models import get_config

    init, jlosses = _jax_dp2_run()
    tokens = _global_tokens(get_config("llama-tiny").vocab_size)
    report_dir = str(tmp_path / "reports")
    config = {"init": init, "tokens": tokens, "ckpt_dir": str(tmp_path / "ckpt")}
    controller = TrainController(
        _dp_program, ScalingConfig(num_workers=N),
        RunConfig(name="mh-dp", failure=FailureConfig(max_failures=0)), config,
        group_factory=lambda: MultihostWorkerGroup(N, run_name="mh-dp", report_dir=report_dir,
                                                   backend="gloo", timeout_s=120),
    )
    result = controller.run()
    assert result.error is None, result.error
    losses = [m["loss"] for m in result.metrics_history if "loss" in m]
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    for rank in range(N):
        reports = _rank_reports(report_dir, rank)
        rank_losses = [m["loss"] for m in reports if "loss" in m]
        assert rank_losses == losses  # every rank reports the same global loss
        assert all(m["num_tokens"] == 8 * 32 for m in reports if "num_tokens" in m)
        last = reports[-1]
        assert last["rank"] == rank
        per = 8 // N
        assert last["rank_rows"] == [tokens[rank * per:(rank + 1) * per].tolist()] * STEPS
        x = np.arange(32).reshape(16, 2)
        assert last["placed"] == [x[b * 8 + rank * 4:b * 8 + rank * 4 + 4].tolist() for b in range(2)]
        assert last["restored"] == 2 and last["bitwise"] is True and last["count"] == 2
        # JAX's accounting: the sync's wire bytes, and its host estimate
        # (bytes / steplog_dp_bandwidth_gbs) in the report window and in
        # each sampled step's dp_sync bucket
        want = jdp_sync_bytes(last["n_params"], N, mode="int8", shard_update=True)
        assert last["dp_sync_mode"] == "int8+shard_update"
        assert last["dp_sync_bytes"] == last["report_bytes"] == want
        est = want / (jcfg.steplog_dp_bandwidth_gbs * 1e9)
        assert last["dp_sync_s"] == round(2 * est, 6)
        assert last["sampled_dp_sync"] and all(
            sync == min(est, sync + rest) for sync, rest in last["sampled_dp_sync"])
    step_dir = tmp_path / "ckpt" / "2"
    files = sorted(os.listdir(step_dir))
    assert {"state.bin", "index.json", "rank0.bin", "rank0.json", "rank1.bin",
            "rank1.json"} <= set(files)
    with open(step_dir / "index.json") as f:
        layout = json.load(f)["layout"]
    assert layout["ranks"] == N
    assert all(v["spec"] == ["dp"] for v in layout["sharded"].values())
    assert any(p.startswith("ef/") for p in layout["sharded"]) and \
        any(p.startswith("opt_state/mu/") for p in layout["sharded"])


def test_report_streaming_and_poll():
    group = MultihostWorkerGroup(num_workers=1, run_name="mh-poll", timeout_s=120)
    try:
        group.start()
        pids = group.pids()
        assert len(pids) == 1 and os.getpid() not in pids
        futs = group.run_async(_report_three, {})
        deadline = time.monotonic() + 60
        seen = 0
        while time.monotonic() < deadline:
            polls = group.poll([seen])
            seen += len(polls[0]["reports"])
            if polls[0]["done"]:
                seen += len(group.poll([seen])[0]["reports"])
                break
            time.sleep(0.1)
        assert seen == 3
        assert group.finish(futs, timeout=10) == ["done"]
    finally:
        group.shutdown()


def test_rank_crash_surfaces_in_poll_and_the_controller():
    """A rank that dies mid-task: poll reports the error (JAX's
    tests/test_multihost.py:135), the future holds WorkerCrashedError, and
    a controller driving a two-rank gang whose rank 1 dies ends ERRORED
    with that error, with no restart left in its budget."""
    group = MultihostWorkerGroup(num_workers=1, run_name="mh-crash", timeout_s=120)
    try:
        group.start()
        futs = group.run_async(_exit_hard, {})
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            polls = group.poll([0])
            if polls[0]["error"] or polls[0]["done"]:
                break
            time.sleep(0.1)
        assert polls[0]["error"] is not None
        with pytest.raises(WorkerCrashedError):
            group.finish(futs, timeout=10)
    finally:
        group.shutdown()
    controller = TrainController(
        _rank1_exits, ScalingConfig(num_workers=N),
        RunConfig(name="mh-crash2", failure=FailureConfig(max_failures=0)), {},
        group_factory=lambda: MultihostWorkerGroup(N, run_name="mh-crash2", backend="gloo",
                                                   timeout_s=120),
    )
    result = controller.run()
    assert result.status.value == "ERRORED" and result.num_restarts == 0
    assert "died" in result.error or "WorkerCrashedError" in result.error
