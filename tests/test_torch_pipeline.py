"""The pipeline schedules of ray_tpu_torch (`parallel/pipeline.py`) against
the JAX package on the CPU.

JAX runs on the virtual CPU devices of tests/conftest.py: its dp=2 x pp=2
and pp=4 meshes on the first four. The port runs one gang of 4 spawned
gloo ranks (`MultihostWorkerGroup`, 120 s timeouts), each stage holding
its layers' blocks and the replicated rest, from JAX's initial
parameters carried with `params_from_numpy`; tokens are numpy from seeds,
each dp rank taking its rows. The rank program is module-level.

Held (f32 throughout):
- the loss at atol = rtol = 1e-5 and every gradient at 1e-4 against
  JAX's `jax.value_and_grad(make_pp_loss_fn(...))`: GPT-2's layout on
  dp=2 x pp=2 (2 microbatches) and pp=4 (4 microbatches, one layer a
  stage), Llama's (RoPE, SwiGLU, GQA) on dp=2 x pp=2;
- GPipe against 1F1B: loss and gradients at 1e-4 (JAX's dry-run bound);
- 3 steps of `make_pp_train_step` under each schedule against JAX's:
  loss and grad_norm at 1e-5, every parameter and Adam moment after them
  at 1e-4 (as tests/test_torch_train.py holds the one-device step);
- `pp_state_specs` as JAX's; the indivisible layer count and batch, and
  a pp mesh with tp, raising.
"""


import numpy as np
import pytest
import torch

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import MeshSpec, P
from ray_tpu_torch.parallel.mesh import Mesh, NamedSharding
from ray_tpu_torch.train.multihost import MultihostWorkerGroup
from ray_tpu_torch.util.tree import flatten

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LR, STEPS = 1e-2, 3
# name -> (model, mesh, microbatches)
CASES = {
    "gpt2 dp2 pp2": ("gpt2", dict(dp=2, pp=2), 2),
    "gpt2 pp4": ("gpt2", dict(pp=4), 4),
    "llama dp2 pp2": ("llama", dict(dp=2, pp=2), 2),
}
STEP_CASE = "gpt2 dp2 pp2"
SCHEDULES = ("gpipe", "1f1b")


def _config(model, torch_side=True):
    """GPT-2's layout at JAX's test width (4 layers) or llama-tiny, f32."""
    if torch_side:
        from ray_tpu_torch.models import get_config

        dt = dict(dtype=torch.float32, param_dtype=torch.float32)
    else:
        import jax.numpy as jnp

        from ray_tpu.models import get_config

        dt = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    if model == "gpt2":
        return get_config("gpt2-small").replace(n_layers=4, d_model=64, n_heads=4, d_ff=128,
                                                vocab_size=128, max_seq=32, **dt)
    return get_config("llama-tiny").replace(**dt)


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (8, 33)).astype(np.int32)


def _view(spec_kw, rank=0):
    return Mesh(MeshSpec(**spec_kw), (torch.device("cpu"),), rank=rank)


# ------------------------------------------------------------ rank program


def _grads_np(grads):
    return {p: g.detach().numpy().copy() for p, g in flatten(grads)}


def _error(call):
    try:
        call()
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return None


def _pp_rank(config):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import (
        build_mesh, create_pp_train_state, data_sharding, make_pp_loss_and_grad,
        make_pp_loss_fn, make_pp_train_step, pp_state_specs,
    )
    from ray_tpu_torch.train import default_optimizer

    torch.set_num_threads(1)
    out = {"rank": dist.get_rank(), "cases": {}}
    for name, (model, spec_kw, mb) in CASES.items():
        cfg = _config(model)
        mesh = build_mesh(MeshSpec(**spec_kw), ["cpu"])
        opt = default_optimizer(LR, total_steps=20)
        params = params_from_numpy(config["params"][model], cfg, device="cpu",
                                   dtype=torch.float32)
        state = create_pp_train_state(cfg, opt, 0, mesh, params=params)
        rows = data_sharding(mesh).shard(torch.from_numpy(config["tokens"][model]))
        case = {"coords": mesh.coords}
        for schedule in SCHEDULES:
            loss, grads = make_pp_loss_and_grad(cfg, mesh, mb, schedule=schedule)(state.params,
                                                                                  rows)
            case[schedule] = dict(loss=loss.item(), grads=_grads_np(grads))
        # the loss alone, differentiated by the caller (every rank runs it)
        loss = make_pp_loss_fn(cfg, mesh, mb)(state.params, rows)
        case["loss_fn"] = loss.item()
        if name == STEP_CASE:
            case["specs"] = {p: tuple(s) for p, s in pp_state_specs(cfg, state).items()}
            for schedule in SCHEDULES:
                state = create_pp_train_state(cfg, opt, 0, mesh, params=params)
                step = make_pp_train_step(cfg, opt, mesh, num_microbatches=mb, schedule=schedule)
                metrics = []
                for _ in range(STEPS):
                    state, m = step(state, {"tokens": rows})
                    metrics.append({k: float(v) for k, v in m.items()})
                case[f"steps_{schedule}"] = dict(
                    metrics=metrics, step=state.step, count=state.opt_state.count,
                    params=_grads_np(state.params), mu=_grads_np(state.opt_state.mu),
                    nu=_grads_np(state.opt_state.nu), stats=step.wires["pp"].stats())
            case["errors"] = {
                "layers": _error(lambda: make_pp_loss_fn(cfg.replace(n_layers=3), mesh, mb)),
                "batch": _error(lambda: make_pp_loss_fn(cfg, mesh, 3)(state.params, rows)),
            }
        out["cases"][name] = case
    tp_mesh = build_mesh(MeshSpec(pp=2, tp=2), ["cpu"])
    out["tp_error"] = _error(lambda: make_pp_loss_fn(_config("gpt2"), tp_mesh, 2))
    return out


# --------------------------------------------------------------- fixtures


def _jax_mesh(spec_kw):
    import jax

    from ray_tpu.parallel import MeshSpec as JMeshSpec, build_mesh as jbuild_mesh

    n = int(np.prod(list(spec_kw.values())))
    return jbuild_mesh(JMeshSpec(**spec_kw), devices=jax.devices()[:n])


def _plain(tree):
    import jax

    return dict(flatten(jax.tree.map(np.asarray, tree)))


@pytest.fixture(scope="module")
def runs():
    """The gang of 4 runs while JAX computes its losses, gradients and
    steps on the virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.transformer import init_params
    from ray_tpu.parallel.pipeline import (
        create_pp_train_state, make_pp_loss_fn, make_pp_train_step, pp_state_specs,
    )
    from ray_tpu.train import default_optimizer
    from ray_tpu_torch.train.lm import _adam_state

    models = {m: _config(m, torch_side=False) for m in ("gpt2", "llama")}
    params = {m: init_params(c, jax.random.PRNGKey(0)) for m, c in models.items()}
    tokens = {m: _tokens(c.vocab_size, seed=1 + i) for i, (m, c) in enumerate(models.items())}
    config = {"params": {m: jax.tree.map(np.asarray, p) for m, p in params.items()},
              "tokens": tokens}
    group = MultihostWorkerGroup(4, run_name="pp", backend="gloo", timeout_s=120)
    try:
        group.start()
        refs = group.run_async(_pp_rank, config)
        out = {"jax": {}, "models": models}
        for name, (model, spec_kw, mb) in CASES.items():
            mesh = _jax_mesh(spec_kw)
            cfg, toks = models[model], jnp.asarray(tokens[model])
            loss, grads = jax.jit(jax.value_and_grad(make_pp_loss_fn(cfg, mesh, mb)))(
                params[model], toks)
            out["jax"][name] = dict(loss=float(loss), grads=_plain(grads))
        model, spec_kw, mb = CASES[STEP_CASE]
        mesh, cfg = _jax_mesh(spec_kw), models[model]
        opt = default_optimizer(LR, total_steps=20)
        for schedule in SCHEDULES:
            # init_params(cfg, PRNGKey(0)) inside: the parameters the ranks carry
            state, sh = create_pp_train_state(cfg, opt, jax.random.PRNGKey(0), mesh)
            step = make_pp_train_step(cfg, opt, mesh, num_microbatches=mb, state_shardings=sh,
                                      schedule=schedule)
            metrics = []
            for _ in range(STEPS):
                state, m = step(state, {"tokens": jnp.asarray(tokens[model])})
                metrics.append({k: float(v) for k, v in m.items()})
            adam = _adam_state(jax.tree.map(np.asarray, state.opt_state))
            out["jax"][f"steps_{schedule}"] = dict(
                metrics=metrics, step=int(state.step), count=int(adam.count),
                params=_plain(state.params), mu=dict(flatten(adam.mu)), nu=dict(flatten(adam.nu)))
        specs = pp_state_specs(cfg, jax.eval_shape(lambda: state)).params
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        out["jax_specs"] = {"/".join(str(k.key) for k in path): tuple(spec)
                            for path, spec in flat}
        out["ranks"] = group.finish(refs, timeout=240)
    finally:
        group.shutdown()
    assert [r["rank"] for r in out["ranks"]] == list(range(4))
    return out


def _assemble(spec_kw, ranks, pick):
    """The global leaf from every rank's: blocks split over pp."""
    out = {}
    for path in pick(ranks[0]):
        spec = P("pp") if path.startswith("blocks/") else P()
        out[path] = NamedSharding(_view(spec_kw), spec).assemble([pick(r)[path] for r in ranks])
    return out


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(runs, name, schedule):
    _, spec_kw, _ = CASES[name]
    want = runs["jax"][name]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["cases"][name][schedule]["loss"], want["loss"], **TOL)
        np.testing.assert_allclose(r["cases"][name]["loss_fn"], want["loss"], **TOL)
    got = _assemble(spec_kw, runs["ranks"], lambda r: r["cases"][name][schedule]["grads"])
    assert set(got) == set(want["grads"])
    for path, g in got.items():
        np.testing.assert_allclose(g, want["grads"][path], err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_gpipe_matches_1f1b(runs, name):
    for r in runs["ranks"]:
        a, b = r["cases"][name]["gpipe"], r["cases"][name]["1f1b"]
        assert abs(a["loss"] - b["loss"]) < 1e-4
        for path, g in a["grads"].items():
            np.testing.assert_allclose(g, b["grads"][path], atol=1e-4, rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_train_steps_match_jax(runs, schedule):
    _, spec_kw, _ = CASES[STEP_CASE]
    want = runs["jax"][f"steps_{schedule}"]
    for r in runs["ranks"]:
        got = r["cases"][STEP_CASE][f"steps_{schedule}"]
        for mine, ref in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose([mine["loss"], mine["grad_norm"]],
                                       [ref["loss"], ref["grad_norm"]], **TOL)
            assert mine["num_tokens"] == 8 * 32
        assert (got["step"], got["count"]) == (want["step"], want["count"]) == (STEPS, STEPS)
        assert got["stats"]["pp_shift"]["bytes"] > 0
    for leaf in ("params", "mu", "nu"):
        got = _assemble(spec_kw, runs["ranks"],
                        lambda r: r["cases"][STEP_CASE][f"steps_{schedule}"][leaf])
        for path, g in got.items():
            np.testing.assert_allclose(g, want[leaf][path], err_msg=f"{leaf} {path}", **GRAD_TOL)


def test_state_specs_match_jax(runs):
    """Every leaf of the params and Adam's moments: the blocks over pp,
    the rest replicated, as JAX's `pp_state_specs` lays them out."""
    want = runs["jax_specs"]
    for r in runs["ranks"]:
        specs = r["cases"][STEP_CASE]["specs"]
        assert {p.split("/", 1)[1] for p in specs if p.startswith("params/")} == set(want)
        for path, spec in specs.items():
            leaf = path.split("/", 2)[-1] if path.startswith("opt_state/") else \
                path.split("/", 1)[1]
            assert spec == want[leaf], path
        assert specs["params/blocks/wq"] == ("pp",) and specs["params/wte"] == ()


def test_indivisible_layers_batch_and_tp_raise(runs):
    from ray_tpu.parallel.pipeline import make_pp_loss_fn as jmake

    model, spec_kw, mb = CASES[STEP_CASE]
    with pytest.raises(ValueError) as info:
        jmake(runs["models"][model].replace(n_layers=3), _jax_mesh(spec_kw), mb)
    for r in runs["ranks"]:
        errors = r["cases"][STEP_CASE]["errors"]
        assert errors["layers"] == ("ValueError", str(info.value))
        assert errors["batch"][0] == "ValueError" and "num_microbatches=3" in errors["batch"][1]
        assert r["tp_error"][0] == "NotImplementedError" and "tp" in r["tp_error"][1]
