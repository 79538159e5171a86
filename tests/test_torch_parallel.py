"""ray_tpu_torch.parallel and the data-parallel train step against the JAX
package on the CPU.

JAX runs on the 8 virtual CPU devices of tests/conftest.py (a dp=2 mesh
on two of them). The port runs two spawned gloo ranks
(`MultihostWorkerGroup`, one module-scoped gang, 120 s timeouts), which
take the same numpy inputs, made from seeds; the ranks' program is
`_rank_program` below (module-level: ranks import this module by name, so
JAX is imported inside the tests only).

Tolerances:
- the int8 quantizer, the quantized reduce-scatter and all-reduce
  (values, scales, reduced rows, residuals): bitwise, on identical inputs;
- the dp=2 step on gpt2-tiny over 3 steps, f32 and f32 + sharded update:
  loss, grad_norm, num_tokens and params at atol = rtol = 1e-4, as
  tests/test_torch_train.py holds the one-device step;
- the int8 modes: the first step's loss at 1e-4 (no update has run), the
  first step's error-feedback residual within one quantization step of
  its block (a 1e-7 difference in a gradient can flip a rounding, which
  moves that element by one block scale; the stage-2 residual of the
  rank's own row adds the reduced row's scale, at most the sum of the
  ranks' stage-1 scales), later losses at rtol 1e-3 and params within
  3 x lr x updates (a flipped rounding moves one element's Adam step by
  at most a few lr), with at most 1 in 1000 elements off by 1e-4.
"""

import types

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import (
    MeshSpec,
    P,
    build_mesh,
    default_rules,
    dp_sync_bytes,
    logical_to_spec,
    override_rules,
    path_specs,
    tree_specs,
    validate_divisibility,
)
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.train.multihost import MultihostWorkerGroup

N = 2  # ranks
BLOCK = 128
DP_STEPS = 3
LR = 1e-3
B, S = 8, 16
MODES = ("f32", "int8", "f32+shard", "int8+shard")
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def _quant_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, N, 4 * BLOCK)).astype(np.float32)
    x[:, :, :BLOCK] = 0.0  # a zero block on every row: scale 1, values 0
    return x


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (B, S + 1)).astype(np.int32)


def _mode_flags(mode):
    return dict(dp_allreduce_dtype="int8" if "int8" in mode else "f32",
                dp_shard_update="shard" in mode)


# ------------------------------------------------------------ rank program


def _rank_program(config):
    """One rank of the gang: quantized collectives on the given rows, the
    eager group calls, then the dp=2 step in every mode from JAX's initial
    states. Returns numpy results (pickled back through the pipe)."""
    import torch.distributed as dist

    from ray_tpu_torch.core.config import cfg
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.parallel import CollectiveGroup, data_sharding
    from ray_tpu_torch.train import (
        default_optimizer, loss_and_grads, make_train_step, train_state_from_numpy, tree_leaves,
    )
    from ray_tpu_torch.train.lm import _to_rows

    torch.set_num_threads(1)
    rank = dist.get_rank()
    mesh = build_mesh(MeshSpec(dp=N), ["cpu"])
    out = {"rank": rank, "axis_index": mesh.axis_index("dp")}
    x = torch.from_numpy(config["quant"][rank])
    own, err = col.quantized_psum_scatter_rows(x, mesh.group("dp"), block=BLOCK)
    out["scatter"] = (own.numpy(), err.numpy())
    red, err = col.quantized_psum_rows(x, mesh.group("dp"), block=BLOCK)
    out["psum"] = (red.numpy(), err.numpy())

    group = CollectiveGroup(mesh, axis="dp", name="t")
    v = torch.arange(8.0) + 4 * rank
    out["eager"] = {
        "sum": group.allreduce(torch.arange(8.0)).numpy(),
        "mean": group.allreduce(v, "mean").numpy(),
        "max": group.allreduce(v, "max").numpy(),
        "min": group.allreduce(v, "min").numpy(),
        "allgather": group.allgather(torch.arange(4.0) + 4 * rank).numpy(),
        "reducescatter": group.reducescatter(torch.ones(4, 8)).numpy(),
        "broadcast": group.broadcast(v, root=1).numpy(),
        "tp_identity": CollectiveGroup(mesh, axis="tp").allreduce(v).numpy(),
    }
    group.barrier()

    model = get_config("gpt2-tiny")
    tokens = torch.from_numpy(config["tokens"])
    local = {"tokens": data_sharding(mesh).shard(tokens)}
    cfg.set(dp_quant_block=BLOCK)
    out["steps"] = {}
    for mode in MODES:
        flags = _mode_flags(mode)
        opt = default_optimizer(LR, warmup_steps=1, total_steps=10,
                                shard_axis="dp" if flags["dp_shard_update"] else None)
        state = train_state_from_numpy(config["init"][mode], model, mesh=mesh)
        # the first step's stage-1 input rows and their block scales
        _, _, grads = loss_and_grads(model, state.params, local["tokens"], loss_chunk=0)
        rows = torch.cat([_to_rows(g, N, BLOCK) for g in grads], dim=1)
        scales = col.quantize_int8_block(rows, BLOCK)[1]
        step = make_train_step(model, opt, mesh=mesh, loss_chunk=0, **flags)
        metrics, ef1 = [], None
        for i in range(DP_STEPS):
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0 and state.ef is not None:
                ef1 = np.concatenate([e[0].numpy() for e in tree_leaves(state.ef)], axis=1)
        out["steps"][mode] = {
            "metrics": metrics,
            "params": [p.detach().numpy() for p in tree_leaves(state.params)],
            "mu": [m.numpy() for m in tree_leaves(state.opt_state.mu)],
            "ef1": ef1,
            "scales": scales.numpy(),
            "wire": step.wire.stats(),
        }
    cfg.reset("dp_quant_block")
    return out


# --------------------------------------------------------------- fixtures


def _jax_mesh():
    import jax

    from ray_tpu.parallel import MeshSpec as JMeshSpec, build_mesh as jbuild_mesh

    return jbuild_mesh(JMeshSpec(dp=N), devices=jax.devices()[:N])


def _plain_state(jstate):
    """A JAX TrainState as plain numpy namespaces (picklable without JAX)."""
    import jax

    from ray_tpu_torch.train.lm import _adam_state

    s = jax.tree.map(np.asarray, jstate)
    adam = _adam_state(s.opt_state)
    opt = types.SimpleNamespace(count=np.asarray(adam.count), mu=adam.mu, nu=adam.nu)
    return types.SimpleNamespace(step=np.asarray(s.step), params=s.params, opt_state=opt, ef=s.ef)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's dp=2 step in every mode: the initial states and 3 steps."""
    import jax

    from ray_tpu.core.config import cfg as jcfg
    from ray_tpu.models import get_config as jget_config
    from ray_tpu.train import create_train_state, default_optimizer, make_train_step

    model = jget_config("gpt2-tiny")
    mesh = _jax_mesh()
    tokens = _tokens(model.vocab_size)
    runs = {}
    jcfg.set(dp_quant_block=BLOCK)
    try:
        for mode in MODES:
            flags = _mode_flags(mode)
            opt = default_optimizer(LR, warmup_steps=1, total_steps=10,
                                    shard_axis="dp" if flags["dp_shard_update"] else None)
            state, sh = create_train_state(
                model, opt, jax.random.PRNGKey(0), mesh,
                dp_shard_update=flags["dp_shard_update"],
                dp_error_feedback=flags["dp_allreduce_dtype"] == "int8",
                dp_quant_block=BLOCK)
            init = _plain_state(state)
            step = make_train_step(model, opt, mesh, state_shardings=sh, loss_chunk=0, **flags)
            metrics, ef1 = [], None
            for i in range(DP_STEPS):
                state, m = step(state, {"tokens": tokens})
                metrics.append({k: float(v) for k, v in m.items()})
                if i == 0 and state.ef is not None:
                    ef1 = np.concatenate([np.asarray(e) for e in jax.tree.leaves(state.ef)],
                                         axis=2)
            runs[mode] = {"init": init, "metrics": metrics, "state": jax.tree.map(np.asarray, state),
                          "ef1": ef1}
    finally:
        jcfg.reset("dp_quant_block")
    return runs


@pytest.fixture(scope="module")
def ranks(jax_runs):
    """The gang's results, by rank."""
    from ray_tpu_torch.models import get_config

    config = {"quant": _quant_inputs(), "tokens": _tokens(get_config("gpt2-tiny").vocab_size),
              "init": {mode: jax_runs[mode]["init"] for mode in MODES}}
    group = MultihostWorkerGroup(N, run_name="parallel-test", backend="gloo", timeout_s=120)
    try:
        group.start()
        out = group.finish(group.run_async(_rank_program, config), timeout=240)
    finally:
        group.shutdown()
    assert [r["rank"] for r in out] == [r["axis_index"] for r in out] == list(range(N))
    return out


def _jax_quantized(fn_name):
    """JAX's quantized collective over its dp=2 mesh on the same rows."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from ray_tpu._jax_compat import shard_map
    from ray_tpu.parallel import collectives as jcol

    fn = getattr(jcol, fn_name)

    @jax.jit
    @partial(shard_map, mesh=_jax_mesh(), in_specs=JP("dp"), out_specs=(JP("dp"), JP("dp")),
             check_vma=False)
    def run(rows):
        a, b = fn(rows[0], "dp", block=BLOCK)
        return a[None], b[None]

    a, b = run(jnp.asarray(_quant_inputs()))
    return np.asarray(a), np.asarray(b)


# ------------------------------------------------------------- quantizer


@pytest.mark.parametrize("shape,block", [((4, 512), 128), ((3, 2, 1024), 512), ((2, 512), 256)])
def test_quantize_int8_block_bitwise_equals_jax(shape, block):
    """Values and scales bitwise equal JAX's on the same f32 input (zero
    blocks, tiny and huge magnitudes, halves that round to even); the
    round trip is within half a step of each block."""
    import jax.numpy as jnp

    from ray_tpu.parallel import collectives as jcol

    rng = np.random.default_rng(sum(shape) + block)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 4, shape)).astype(np.float32)
    x[..., :block] = 0.0
    x.reshape(-1)[block:block + 4] = np.float32([0.5, 1.5, -2.5, 127.0])
    q, s = col.quantize_int8_block(torch.from_numpy(x), block)
    jq, js = jcol.quantize_int8_block(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    deq = col.dequantize_int8_block(q, s)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jcol.dequantize_int8_block(jq, js)))
    bound = np.repeat(s.numpy(), block, axis=-1) * 0.5
    assert (np.abs(x - deq.numpy()) <= bound).all()
    assert (deq.numpy()[..., :block] == 0.0).all()
    with pytest.raises(ValueError, match="divisible"):
        col.quantize_int8_block(torch.zeros(3, block + 1), block)


def test_quantized_psum_scatter_rows_bitwise_equals_jax(ranks):
    """Each rank's owned row and residual equal JAX's member's, bitwise;
    the residuals close the books against the exact sum."""
    jown, jerr = _jax_quantized("quantized_psum_scatter_rows")
    x = _quant_inputs()
    for r, out in enumerate(ranks):
        own, err = out["scatter"]
        np.testing.assert_array_equal(own, jown[r])
        np.testing.assert_array_equal(err, jerr[r])
    own = np.stack([o["scatter"][0] for o in ranks])
    err = np.stack([o["scatter"][1] for o in ranks])
    np.testing.assert_allclose(own + err.sum(axis=0), x.sum(axis=0), atol=1e-4)


def test_quantized_psum_rows_bitwise_equals_jax(ranks):
    """The reduced rows (the same on both ranks) and each rank's combined
    residual equal JAX's, bitwise; reduced + all residuals = the exact
    f32 sum."""
    jred, jerr = _jax_quantized("quantized_psum_rows")
    for r, out in enumerate(ranks):
        red, err = out["psum"]
        np.testing.assert_array_equal(red, jred[r])
        np.testing.assert_array_equal(err, jerr[r])
    np.testing.assert_array_equal(ranks[0]["psum"][0], ranks[1]["psum"][0])
    err = np.stack([o["psum"][1] for o in ranks])
    np.testing.assert_allclose(ranks[0]["psum"][0] + err.sum(axis=0),
                               _quant_inputs().sum(axis=0), atol=1e-4)


# ------------------------------------------------------------ eager groups


def test_eager_collective_group_matches_jax(ranks):
    """The eager calls of JAX's tests/test_parallel.py on a dp=2 group:
    allreduce sum / mean / max / min, allgather stacking the members'
    tensors, reducescatter handing each member its block of the sum,
    broadcast from a root, barrier; a group over an axis of size 1 is the
    identity. JAX's results on its dp=2 mesh are the reference."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.parallel import collectives as jcol

    jg = jcol.CollectiveGroup(_jax_mesh(), axis="dp", name="ref")
    per_rank = [np.arange(8.0) + 4 * r for r in range(N)]
    sharded = jax.device_put(jnp.asarray(np.concatenate(per_rank)),
                             NamedSharding(_jax_mesh(), JP("dp")))
    ref = {
        "sum": np.asarray(jg.allreduce(jnp.arange(8.0))),
        "allgather": np.asarray(jg.allgather(jax.device_put(
            jnp.asarray(np.concatenate([np.arange(4.0) + 4 * r for r in range(N)])),
            NamedSharding(_jax_mesh(), JP("dp"))))),
        "reducescatter": np.asarray(jg.reducescatter(jnp.ones((4, 8)))),
    }
    for op in ("mean", "max", "min"):
        ref[op] = np.asarray(jg.allreduce(sharded, op)).reshape(N, 8)[0]
    jg.barrier()
    for r, out in enumerate(ranks):
        eager = out["eager"]
        np.testing.assert_array_equal(eager["sum"], ref["sum"])
        for op in ("mean", "max", "min"):
            np.testing.assert_array_equal(eager[op], ref[op])
        np.testing.assert_array_equal(eager["allgather"], ref["allgather"])
        rows = 4 // N
        np.testing.assert_array_equal(eager["reducescatter"], ref["reducescatter"][r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(eager["broadcast"], per_rank[1])
        np.testing.assert_array_equal(eager["tp_identity"], per_rank[r])


# ---------------------------------------------------------- sharding rules


def test_sharding_rules_match_jax():
    """default_rules, override_rules, logical_to_spec (no mesh axis used
    twice), tree_specs on the model's logical axes, path_specs' search
    semantics and validate_divisibility, against JAX's on the same input."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.models.transformer import logical_axes as jlogical_axes
    from ray_tpu.models import get_config as jget_config
    from ray_tpu.parallel import sharding as jsh
    from ray_tpu_torch.models import get_config, logical_axes

    assert default_rules() == jsh.default_rules()
    assert override_rules(default_rules(), embed="tp", extra="dp") == \
        jsh.override_rules(jsh.default_rules(), embed="tp", extra="dp")
    for axes in (("batch", "embed"), ("embed", "mlp"), ("mlp", "vocab"), ("batch", "seq", None),
                 ("layers", "embed", "kv_heads", "head_dim"), ("unknown",)):
        for rules in (default_rules(), override_rules(default_rules(), embed="tp")):
            assert tuple(logical_to_spec(axes, rules)) == tuple(jsh.logical_to_spec(axes, rules))
    assert logical_to_spec(("mlp", "vocab"), default_rules()) == P("tp", None)
    for name in ("gpt2-tiny", "llama-tiny"):
        mine = tree_specs(logical_axes(get_config(name)), default_rules())
        ref = jsh.tree_specs(jlogical_axes(jget_config(name)), jsh.default_rules())
        assert set(mine) == set(ref)
        for key in mine:
            if key == "blocks":
                assert {k: tuple(v) for k, v in mine[key].items()} == \
                    {k: tuple(v) for k, v in ref[key].items()}
            else:
                assert tuple(mine[key]) == tuple(ref[key])
    rules = [(r"wq_norm", P()), (r"wq", P("tp"))]
    tree = {"decoder": {"wq": torch.ones(4, 4), "wq_norm": torch.ones(4)}}
    jtree = {"decoder": {"wq": jnp.ones((4, 4)), "wq_norm": jnp.ones((4,))}}
    specs = path_specs(tree, rules)
    jspecs = jsh.path_specs(jtree, [(r"wq_norm", JP()), (r"wq", JP("tp"))])
    assert tuple(specs["decoder"]["wq"]) == tuple(jspecs["decoder"]["wq"]) == ("tp",)
    assert tuple(specs["decoder"]["wq_norm"]) == tuple(jspecs["decoder"]["wq_norm"]) == ()
    mesh = build_mesh(MeshSpec(), ["cpu"])
    validate_divisibility((8, 3), P("dp", None), mesh)
    # a mesh past dp needs a torch.distributed job of its size, as a dp
    # mesh does (sp, ep and pp too)
    with pytest.raises(ValueError, match="torch.distributed"):
        build_mesh(MeshSpec(dp=2, tp=2), ["cpu"])
    for kw in ({"sp": 2}, {"ep": 2}, {"pp": 2}):
        with pytest.raises(ValueError, match="torch.distributed"):
            build_mesh(MeshSpec(**kw), ["cpu"])


# ------------------------------------------------------------- the dp step


def _jax_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mode", MODES)
def test_dp_step_matches_jax(mode, jax_runs, ranks):
    """The dp=2 step in each mode, 3 steps on gpt2-tiny from JAX's initial
    state: metrics on both ranks, params (equal bitwise on the two ranks),
    each rank's moments (its row, under the sharded update), the first
    step's error-feedback residual, and the bytes each rank's collectives
    moved against dp_sync_bytes at the rows layout's padded size."""
    ref = jax_runs[mode]
    flags = _mode_flags(mode)
    int8 = flags["dp_allreduce_dtype"] == "int8"
    runs = [out["steps"][mode] for out in ranks]
    for run in runs:
        for i, (jm, tm) in enumerate(zip(ref["metrics"], run["metrics"])):
            assert tm["num_tokens"] == jm["num_tokens"] == B * S
            if not int8 or i == 0:
                for key in ("loss", "grad_norm"):
                    np.testing.assert_allclose(tm[key], jm[key], **STEP_TOL, err_msg=f"{key} {i}")
            else:
                np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-3)
    for a, b in zip(runs[0]["params"], runs[1]["params"]):
        np.testing.assert_array_equal(a, b)  # replicas stay identical
    if mode == "f32+shard":
        # the sharded update is the replicated one, bitwise: the same
        # gradients, elementwise Adam, and a clip norm that rounds alike
        for a, b in zip(runs[0]["params"], ranks[0]["steps"]["f32"]["params"]):
            np.testing.assert_array_equal(a, b)
    jparams = _jax_leaves(ref["state"].params)
    updates = DP_STEPS - 1  # the schedule's first step moves nothing
    for jp, tp in zip(jparams, runs[0]["params"]):
        if int8:
            np.testing.assert_allclose(tp, jp, atol=3 * LR * updates, rtol=0)
            off = np.abs(tp - jp) > 1e-4 + 1e-4 * np.abs(jp)
            assert off.mean() <= 1e-3
        else:
            np.testing.assert_allclose(tp, jp, **STEP_TOL)
    from ray_tpu_torch.train.lm import _adam_state

    jmu = _jax_leaves(_adam_state(ref["state"].opt_state).mu)
    for r, run in enumerate(runs):
        for jm, tm in zip(jmu, run["mu"]):
            want = jm[r:r + 1] if flags["dp_shard_update"] else jm
            assert tm.shape == want.shape
            if not int8:
                np.testing.assert_allclose(tm, want, **STEP_TOL)
    if int8:
        for r, run in enumerate(runs):
            scale = np.repeat(run["scales"], BLOCK, axis=-1)  # (n, K): the stage-1 steps
            bound = scale.copy()
            if not flags["dp_shard_update"]:
                # the own row also holds the stage-2 residual of the reduced row
                bound[r] += sum(np.repeat(o["steps"][mode]["scales"][r], BLOCK) for o in ranks)
            diff = np.abs(run["ef1"] - ref["ef1"][r])
            assert (diff <= bound * (1 + 1e-5) + 1e-7).all()
            # a stage-1 residual is at most half its block's step, plus the
            # rounding of x / scale (at most 127 x 2^-24 of a step)
            stage1 = [i for i in range(N) if flags["dp_shard_update"] or i != r]
            assert (np.abs(run["ef1"][stage1]) <= 0.5 * scale[stage1] * (1 + 2.0 ** -16)).all()
    # the bytes of the gradient sync and of the sharded update's gather,
    # against dp_sync_bytes at the padded size of the rows layout
    from ray_tpu_torch.train.lm import _rows_k

    n_params = sum(p.size for p in jparams)
    padded = N * sum(_rows_k(p.size, N, BLOCK) for p in jparams)
    for run in runs:
        wire = run["wire"]
        moved = wire["dp_sync"]["bytes"] + wire.get("dp_gather", {}).get("bytes", 0)
        if mode == "f32":
            assert moved == DP_STEPS * dp_sync_bytes(n_params, N)
        else:
            assert moved == DP_STEPS * dp_sync_bytes(padded, N, mode=flags["dp_allreduce_dtype"],
                                                     shard_update=flags["dp_shard_update"],
                                                     block=BLOCK)
        assert wire["dp_sync"]["seconds"] > 0.0
