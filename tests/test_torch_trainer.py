"""ray_tpu_torch's LMTrainer, LM batch feed, cost layer and mesh
vocabulary against the JAX package on the CPU.

The JAX trainer runs on the 8 virtual CPU devices of tests/conftest.py
over an explicit `MeshSpec(fsdp=8)`; the port's on `device="cpu"`, from
the JAX trainer's initial state carried over with
`train_state_from_numpy`. Batches are numpy token arrays made from a
seed, fed to both.

Tolerances: per-step losses and grad norms and the final parameters at
atol = rtol = 1e-4 (f32 through gpt2-tiny's 4 layers and up to 10 Adam
updates; JAX's fsdp=8 step sums its gradients in another order), as
tests/test_torch_train.py holds the step. The batch feed is held equal
exactly (integers), the cost count to 1% of the closed form (it is exact
in practice: the count's FLOPs are the products'), the roofline dicts
exactly (the same float arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.data import lm as jdata_lm
from ray_tpu.models import get_config as jget_config
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel.collectives import dp_sync_bytes as jdp_sync_bytes
from ray_tpu.train import LMTrainer as JLMTrainer
from ray_tpu.train import config as jtrain_config
from ray_tpu.util import profiling as jprofiling
from ray_tpu_torch.core.config import cfg as tcfg
from ray_tpu_torch.data import DataContext, lm_batch_iterator, pack_tokens
from ray_tpu_torch.models import get_config
from ray_tpu_torch.parallel import MeshSpec, build_mesh, dp_sync_bytes, single_device_mesh
from ray_tpu_torch.train import (
    CheckpointConfig,
    LMTrainer,
    config as ttrain_config,
    default_optimizer,
    make_train_step,
    train_state_from_numpy,
    tree_leaves,
)
from ray_tpu_torch.util import profiling

STEP_TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 8, 16  # fsdp=8 splits the batch over the 8 CPU devices


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast as many and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (B, S + 1)).astype(np.int32)} for _ in range(n)]


def _jax_trainer(**kw):
    return JLMTrainer(jget_config("gpt2-tiny"), mesh_spec=JMeshSpec(fsdp=8),
                      learning_rate=1e-3, total_steps=10, **kw)


def _carried(jtrainer, **kw):
    """The port's trainer on the CPU, continuing from the JAX trainer's state."""
    trainer = LMTrainer(get_config("gpt2-tiny"), learning_rate=1e-3, total_steps=10,
                        device="cpu", **kw)
    trainer.state = train_state_from_numpy(jax.tree.map(np.asarray, jtrainer.state),
                                           trainer.config, device="cpu")
    return trainer


def _train(trainer, batches):
    """Train on the batches, reporting every step; returns the reports."""
    reports = []
    trainer.train(batches, num_steps=len(batches), report_every=1, report_fn=reports.append)
    return reports


def _leaves_close(jtree, ttree, **tol):
    jleaves, tleaves = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jleaves) == len(tleaves)
    for jl, tl in zip(jleaves, tleaves):
        np.testing.assert_allclose(np.asarray(jl), tl.detach().numpy(), **tol)


# ------------------------------------------------------------------ trainer


def test_trainer_matches_jax_trainer_over_ten_steps():
    """Both trainers from the same carried-over initial weights, 10 steps
    on the same batches: every report's loss and grad norm, then every
    final parameter and Adam moment. The port's counted step FLOPs are
    printed beside JAX's cost_analysis (XLA's own count of its compiled,
    sharded program, which counts other work than the products: the two
    are not held equal)."""
    jtrainer = _jax_trainer()
    ttrainer = _carried(jtrainer)
    batches = _batches(0, 10, ttrainer.config.vocab_size)
    jreports, treports = _train(jtrainer, batches), _train(ttrainer, batches)
    assert len(jreports) == len(treports) == 10
    for jr, tr in zip(jreports, treports):
        assert jr["step"] == tr["step"]
        for key in ("loss", "grad_norm", "num_tokens"):
            np.testing.assert_allclose(jr[key], tr[key], **STEP_TOL, err_msg=key)
        # the same report keys, profiling ones included
        assert set(jr) - {"_steplog", "_mono"} == set(tr) - {"_steplog", "_mono"}
    assert ttrainer.state.step == int(jtrainer.state.step) == 10
    _leaves_close(jtrainer.state.params, ttrainer.state.params, **STEP_TOL)
    jadam = jtrainer.state.opt_state[1][0]
    _leaves_close(jadam.mu, ttrainer.state.opt_state.mu, **STEP_TOL)
    _leaves_close(jadam.nu, ttrainer.state.opt_state.nu, **STEP_TOL)
    assert ttrainer.state.opt_state.count == int(jadam.count) == 10
    jcost = jtrainer.step_cost({"tokens": jnp.asarray(batches[0]["tokens"])})
    tcost = ttrainer.step_cost(batches[0])
    print(f"step FLOPs: port (counted products) {tcost.flops:.6e}, JAX cost_analysis "
          f"{jcost.total_flops:.6e} (not held equal); bytes: port "
          f"{tcost.bytes_accessed:.6e}, JAX {jcost.total_bytes:.6e}")
    assert treports[-1]["dp_sync_mode"] == "xla_psum" and treports[-1]["dp_sync_bytes"] == 0


def test_lm_trainer_with_checkpoint_resume(tmp_path):
    """tests/test_train.py::test_lm_trainer_with_checkpoint_resume on the
    port: checkpoints every 5 of 10 steps, and a new trainer resumes at
    step 10 with the same parameters (bitwise: the port's own format)."""
    config = get_config("gpt2-tiny")
    ckpt = CheckpointConfig(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=5)
    trainer = LMTrainer(config, learning_rate=1e-3, total_steps=10, checkpoint_config=ckpt,
                        device="cpu")
    metrics = trainer.train(_batches(0, 10, config.vocab_size), num_steps=10, report_every=5)
    assert metrics["step"] == 10
    assert metrics["tokens_per_sec"] > 0
    assert trainer.ckpt_mgr.latest_step() == 10
    trainer2 = LMTrainer(config, learning_rate=1e-3, total_steps=10, checkpoint_config=ckpt,
                         device="cpu")
    assert trainer2.maybe_restore() == 10
    for a, b in zip(tree_leaves(trainer.state.params), tree_leaves(trainer2.state.params)):
        assert torch.equal(a, b) and b.requires_grad and b.is_leaf
    assert trainer2.state.opt_state.count == 10
    # restore(step) picks an older step; training continues from it
    assert trainer2.restore(5) == 5
    trainer2.train(_batches(1, 2, config.vocab_size), num_steps=2, report_every=1)
    assert trainer2.state.step == 7


def test_jax_state_at_step_five_continues_in_the_port():
    """A JAX TrainState after 5 steps carried into the port: both packages
    take 5 more steps on the same batches with the same losses (the
    schedule continues from the carried Adam count)."""
    jtrainer = _jax_trainer()
    batches = _batches(2, 10, jtrainer.config.vocab_size)
    _train(jtrainer, batches[:5])
    ttrainer = _carried(jtrainer)
    assert ttrainer.state.step == 5 and ttrainer.state.opt_state.count == 5
    jreports, treports = _train(jtrainer, batches[5:]), _train(ttrainer, batches[5:])
    np.testing.assert_allclose([r["loss"] for r in jreports], [r["loss"] for r in treports],
                               **STEP_TOL)
    assert [r["step"] for r in treports] == [6, 7, 8, 9, 10]
    _leaves_close(jtrainer.state.params, ttrainer.state.params, **STEP_TOL)


def test_trainer_takes_numpy_and_device_batches_alike():
    """A numpy batch, a CPU tensor batch and a batch of lm_batch_iterator
    give the same step; num_steps stops the loop; report_every=3 reports at
    steps 3 and 4 (the last)."""
    config = get_config("gpt2-tiny")
    batches = _batches(3, 4, config.vocab_size)
    runs = []
    for feed in ("numpy", "tensor"):
        trainer = LMTrainer(config, learning_rate=1e-3, total_steps=10, device="cpu")
        data = batches if feed == "numpy" else [{"tokens": torch.from_numpy(b["tokens"])}
                                                 for b in batches]
        reports = []
        trainer.train(data + data, num_steps=4, report_every=3, report_fn=reports.append)
        assert [r["step"] for r in reports] == [3, 4]
        runs.append(reports)
    assert [r["loss"] for r in runs[0]] == [r["loss"] for r in runs[1]]


def test_profiling_metrics_never_fail_a_run(monkeypatch):
    """Cost accounting must never fail a training run: a count that raises
    leaves the report without its profiling keys; the flag off leaves only
    step_time_s."""
    config = get_config("gpt2-tiny")
    trainer = LMTrainer(config, learning_rate=1e-3, total_steps=10, device="cpu")
    metrics = trainer.profiling_metrics(_batches(4, 1, config.vocab_size)[0], 0.5)
    assert 0.0 < metrics["mfu"] and metrics["step_time_s"] == 0.5
    assert metrics["roofline_bound"] in ("memory", "compute")

    def broken(batch):
        raise RuntimeError("no count")

    monkeypatch.setattr(trainer, "step_cost", broken)
    assert trainer.profiling_metrics({}, 0.5) == {}
    tcfg.set(profile_cost_accounting=False)
    try:
        assert trainer.profiling_metrics({}, 0.5) == {"step_time_s": 0.5}
    finally:
        tcfg.reset("profile_cost_accounting")


# --------------------------------------------------------------- batch feed


class _Blocks:
    """Any object with iter_blocks(): token blocks of uneven sizes, a flat
    stream and a ragged per-document column."""

    def __init__(self, seed, ragged=False):
        self.seed, self.ragged = seed, ragged

    def iter_blocks(self):
        rng = np.random.default_rng(self.seed)
        for n in (50, 7, 300, 41, 129):
            if self.ragged:
                docs = [rng.integers(0, 97, rng.integers(1, 30)) for _ in range(n // 10 + 1)]
                col = np.empty(len(docs), dtype=object)
                col[:] = docs
                yield {"tokens": col}
            else:
                yield {"tokens": rng.integers(0, 97, n)}


@pytest.mark.parametrize("ragged", [False, True], ids=["flat", "ragged"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_pack_tokens_matches_jax(ragged, drop_last):
    mine = list(pack_tokens(_Blocks(5, ragged).iter_blocks(), 9, 4, drop_last=drop_last))
    ref = list(jdata_lm.pack_tokens(_Blocks(5, ragged).iter_blocks(), 9, 4, drop_last=drop_last))
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["tokens"].dtype == np.int32


def test_lm_batch_iterator_matches_jax_batches():
    """The same blocks through both packages' lm_batch_iterator: equal
    batches, in order; the port's are tensors on the requested device."""
    assert DataContext.get_current().target_batch_prefetch == 2
    mine = list(lm_batch_iterator(_Blocks(6), 9, 4, device="cpu"))
    ref = list(jdata_lm.lm_batch_iterator(_Blocks(6), 9, 4))
    assert len(mine) == len(ref) > 0
    for a, b in zip(mine, ref):
        assert isinstance(a["tokens"], torch.Tensor) and a["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(a["tokens"].numpy(), np.asarray(b["tokens"]))
    with pytest.raises(NotImplementedError, match="A7"):
        lm_batch_iterator(_Blocks(6), 9, 4, device="cpu", sharding=object())


def test_batch_stream_yields_the_first_batch_before_filling_the_window():
    """The first batch is handed over after ONE pull from the host
    iterator; after that the window tops up to target_batch_prefetch
    batches behind the consumer (JAX's _jax_batch_stream schedule)."""
    from ray_tpu_torch.data.dataset import _torch_batch_stream

    pulled = []

    def host():
        for i in range(5):
            pulled.append(i)
            yield {"tokens": np.full((2, 3), i, np.int32)}

    stream = _torch_batch_stream(host(), 2, "cpu", None)
    assert pulled == []  # nothing pulled before the first next()
    first = next(stream)
    assert pulled == [0] and int(first["tokens"][0, 0]) == 0
    second = next(stream)
    assert pulled == [0, 1, 2] and int(second["tokens"][0, 0]) == 1
    assert [int(b["tokens"][0, 0]) for b in stream] == [2, 3, 4]


# --------------------------------------------------------------------- cost


def _products_closed_form(config, b, s, recompute=False):
    """FLOPs of the step's products: every matrix product three times
    (forward, dX, dW); attention's 2 forward + 5 backward products of
    2 * D per causal pair (the flash kernels' function). With remat each
    block's forward runs once more in the backward up to its last product:
    torch.utils.checkpoint stops recomputing once every tensor the
    backward saved is back, and the down projection's output is not one
    of them."""
    e, f, v, h, d, n = (config.d_model, config.d_ff, config.vocab_size, config.n_heads,
                        config.head_dim, config.n_layers)
    block = 2.0 * b * s * (4 * e * e + 2 * e * f) * n
    head = 2.0 * b * s * e * v
    attn_pair = 2.0 * d * b * h * s * (s + 1) / 2 * n
    total = 3 * (block + head) + 7 * attn_pair
    if recompute:
        total += block - 2.0 * b * s * f * e * n + 2 * attn_pair
    return total


@pytest.mark.parametrize("remat", [False, True])
def test_step_cost_counts_the_products(remat):
    """step_cost's FLOPs at gpt2-tiny equal the closed-form count of the
    step's products to 1% (remat's recompute included), its bytes are
    positive, and the live state is not touched (the count runs on meta
    copies)."""
    config = get_config("gpt2-tiny").replace(remat=remat)
    opt = default_optimizer(1e-3, total_steps=10)
    trainer = LMTrainer(config, optimizer=opt, device="cpu")
    before = [t.clone() for t in tree_leaves(trainer.state.params)]
    tokens = torch.from_numpy(_batches(7, 1, config.vocab_size)[0]["tokens"])
    step = make_train_step(config, opt, device="meta", loss_chunk=0)
    cost = profiling.step_cost(step, trainer.state, {"tokens": tokens})
    want = _products_closed_form(config, B, S, recompute=remat)
    print(f"remat={remat}: counted {cost.flops:.6e} FLOPs, closed form {want:.6e}, "
          f"{cost.bytes_accessed:.6e} bytes; largest: {cost.top_buckets(4)}")
    assert abs(cost.flops - want) <= 0.01 * want
    assert cost.bytes_accessed > 0 and cost.n_devices == 1
    assert cost.device_kind == "cpu" and cost.estimated_peaks
    # the kernels' custom ops are counted as ops: their flop formulas and
    # their inputs and outputs
    for op in ("flash_attention_fwd", "flash_attention_bwd"):
        assert cost.buckets[f"flops ray_tpu_torch.{op}"] > 0
        assert cost.buckets[f"bytes ray_tpu_torch.{op}"] > 0
    assert trainer.state.step == 0 and trainer.state.opt_state.count == 0
    for a, b in zip(before, tree_leaves(trainer.state.params)):
        assert torch.equal(a, b)
    # the trainer's cached count is the same count
    assert trainer.step_cost({"tokens": tokens}).flops == cost.flops


def test_roofline_and_peaks_match_jax():
    """roofline() gives JAX's dict for the same StepCost numbers; an
    unknown device gets JAX's nominal fallback peaks, flagged estimated."""
    fields = dict(flops=6.6e12, bytes_accessed=9.1e10, buckets={"flops": 6.6e12},
                  device_kind="NVIDIA H100 80GB HBM3", n_devices=1, peak_flops=989e12,
                  peak_hbm_bps=3.35e12, estimated_peaks=False)
    for step_s in (0.081, 0.5, 3.0):
        assert profiling.roofline(profiling.StepCost(**fields), step_s) == \
            jprofiling.roofline(jprofiling.StepCost(**fields), step_s)
    mine = profiling.StepCost(**{**fields, "buckets": {"a": 1.0, "b": -5.0, "c": 3.0}})
    assert mine.top_buckets(2) == [("b", -5.0), ("c", 3.0)]
    peaks = profiling.device_peaks("cpu")
    assert peaks["estimated"] and peaks["peak_flops"] == jprofiling._FALLBACK_PEAK_FLOPS
    assert peaks["peak_hbm_bps"] == jprofiling._FALLBACK_HBM_BPS
    assert profiling._PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12
    from ray_tpu_torch.core.exceptions import ProfilingError

    with pytest.raises(ProfilingError):
        profiling.roofline(profiling.StepCost(**fields), 0.0)


# -------------------------------------------------- mesh, dp sync, configs


def test_mesh_spec_and_dp_sync_bytes_match_jax():
    for kw in ({}, {"fsdp": 8}, {"dp": 2, "fsdp": 2, "tp": 2}, {"pp": 3, "sp": 2}):
        mine, ref = MeshSpec(**kw), JMeshSpec(**kw)
        assert (mine.shape, mine.axis_names, mine.num_devices, mine.describe()) == \
            (ref.shape, ref.axis_names, ref.num_devices, ref.describe())
        for n in (ref.num_devices, 2 * ref.num_devices):
            assert mine.with_devices(n).shape == ref.with_devices(n).shape
    with pytest.raises(ValueError):
        MeshSpec(tp=2).with_devices(3)
    mesh = build_mesh(MeshSpec(), ["cpu"])
    assert mesh.device.type == "cpu" and mesh.shape == {a: 1 for a in mesh.axis_names}
    assert single_device_mesh("cpu").devices == mesh.devices
    with pytest.raises(NotImplementedError, match="A7"):
        build_mesh(MeshSpec(fsdp=8), ["cpu"])
    with pytest.raises(NotImplementedError, match="A7"):
        LMTrainer(get_config("gpt2-tiny"), mesh_spec=MeshSpec(dp=2), device="cpu")
    for n_params in (1000, 124_439_808):
        for n in (1, 2, 8):
            for mode in ("f32", "int8"):
                for shard in (False, True):
                    assert dp_sync_bytes(n_params, n, mode=mode, shard_update=shard) == \
                        jdp_sync_bytes(n_params, n, mode=mode, shard_update=shard)


def test_lm_trainer_refuses_dp_sync_modes_it_cannot_run(monkeypatch):
    """One device has no dp axis: an int8 or sharded-update sync, asked for
    by argument or by flag, raises naming ROADMAP A7 instead of being
    ignored."""
    config = get_config("gpt2-tiny")
    with pytest.raises(NotImplementedError, match="A7"):
        LMTrainer(config, dp_allreduce_dtype="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        LMTrainer(config, dp_shard_update=True, device="cpu")
    monkeypatch.setenv("RAY_TPU_DP_ALLREDUCE_DTYPE", "int8")
    with pytest.raises(NotImplementedError, match="A7"):
        LMTrainer(config, device="cpu")
    trainer = LMTrainer(config, dp_allreduce_dtype="f32", device="cpu")
    assert (trainer.dp_sync_mode, trainer.dp_sync_bytes) == ("xla_psum", 0)


def test_train_configs_and_flags_match_jax(monkeypatch):
    """The train configs keep JAX's fields and defaults (a worker's
    accelerator is the GPU where JAX's is the TPU); the flags this slice
    reads keep JAX's names, defaults and RAY_TPU_<NAME> overrides."""
    from ray_tpu.core.config import _REGISTRY as jflags
    from ray_tpu_torch.core.config import _REGISTRY as tflags

    for name in ("FailureConfig", "CheckpointConfig", "RunConfig"):
        mine, ref = getattr(ttrain_config, name)(), getattr(jtrain_config, name)()
        assert {k: v for k, v in vars(mine).items() if k not in ("failure", "checkpoint")} == \
            {k: v for k, v in vars(ref).items() if k not in ("failure", "checkpoint")}
    scaling = ttrain_config.ScalingConfig(use_gpu=True)
    assert scaling.worker_resources() == {"GPU": 1.0}
    assert ttrain_config.ScalingConfig().worker_resources() == {"CPU": 1.0}
    for name in ("dp_allreduce_dtype", "dp_shard_update", "dp_quant_block",
                 "steplog_dp_bandwidth_gbs", "train_step_log", "train_step_log_marks",
                 "train_step_log_steps", "step_log_sample_every", "profile_cost_accounting",
                 "events_segment_bytes", "events_segments_keep"):
        mine, ref = tflags[name], jflags[name]
        assert (mine.default, mine.type, mine.env_var) == (ref.default, ref.type, ref.env_var)
    monkeypatch.setenv("RAY_TPU_STEP_LOG_SAMPLE_EVERY", "7")
    assert tcfg.step_log_sample_every == 7
