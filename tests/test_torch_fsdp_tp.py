"""FSDP and tensor-parallel training of ray_tpu_torch against JAX's GSPMD
on the CPU.

JAX runs on the 8 virtual CPU devices of tests/conftest.py: each mesh of
four ranks on `jax.devices()[:4]`, dp=2 x fsdp=2 x tp=2 on all eight. The
port runs spawned gloo ranks (`MultihostWorkerGroup`, 120 s timeouts):
one gang of 4 for the meshes of four ranks, one of 8 for dp=2 x fsdp=2 x
tp=2. Every rank takes the same numpy inputs, made from seeds, and JAX's
initial states; the ranks' programs are module-level (ranks import this
module by name, so JAX is imported inside the tests only). A world of 4
ranks cannot hold a mesh of 2, so "fsdp=2" and "tp=2" run beside dp=2:
dp=2 x fsdp=2 and dp=2 x tp=2.

Tolerances (f32 throughout):
- the sharded forward's logits and the vocab-parallel losses with their
  gradients: atol = rtol = 1e-5;
- the steps: loss, grad_norm and num_tokens of each of 3 steps at atol =
  rtol = 1e-5; every parameter and Adam moment after them, reassembled
  from the ranks' blocks, at atol = rtol = 1e-4, as
  tests/test_torch_train.py holds the one-device step (Adam's normalised
  update turns a last-bit difference in a nearly cancelling gradient
  element into a visible share of that element's step);
- the step's counted FLOPs: the ranks' sum equals the one-device count
  (the products are split, not approximated); the checkpoint: bitwise.
"""

import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import MeshSpec, NamedSharding, P
from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.train.multihost import MultihostWorkerGroup

LR = 1e-3
STEPS = 3
B, S = 8, 16
TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
MODELS = ("gpt2-tiny", "llama-tiny")
# name -> (model, mesh, step options); each on 4 ranks but the last. The
# eval step is held on the first two and the last.
CASES = {
    "gpt2 fsdp2 tp2": ("gpt2-tiny", dict(fsdp=2, tp=2), dict(grad_clip=0.5)),
    "llama fsdp2 tp2": ("llama-tiny", dict(fsdp=2, tp=2), dict(loss_chunk=8, z_loss_coeff=1e-3)),
    "gpt2 dp2 fsdp2": ("gpt2-tiny", dict(dp=2, fsdp=2), dict(grad_accum=2)),
    "llama dp2 fsdp2": ("llama-tiny", dict(dp=2, fsdp=2), dict(grad_clip=0.5, z_loss_coeff=1e-3)),
    "gpt2 dp2 tp2": ("gpt2-tiny", dict(dp=2, tp=2), dict(z_loss_coeff=1e-3)),
    "llama dp2 tp2": ("llama-tiny", dict(dp=2, tp=2), dict(grad_accum=2, grad_clip=0.5)),
    "llama dp2 fsdp2 tp2": ("llama-tiny", dict(dp=2, fsdp=2, tp=2), dict(grad_clip=0.5)),
}
CASES4 = [c for c in CASES if np.prod(list(CASES[c][1].values())) == 4]
CASES8 = [c for c in CASES if c not in CASES4]
EVAL_CASES = ("gpt2 fsdp2 tp2", "llama fsdp2 tp2", "llama dp2 fsdp2 tp2")
CKPT_CASE = "gpt2 fsdp2 tp2"


def _tokens(vocab, seed=1, rows=B):
    return np.random.default_rng(seed).integers(0, vocab, (rows, S + 1)).astype(np.int32)


def _opt_kw(options):
    return dict(warmup_steps=1, total_steps=10, grad_clip=options.get("grad_clip", 1.0))


def _step_kw(options):
    return {k: v for k, v in options.items() if k != "grad_clip"}


def _mesh(spec_kw, rank=0):
    """A Mesh of the spec seen from `rank`, without process groups: enough
    to lay blocks out (`NamedSharding.shard` / `assemble`)."""
    return Mesh(MeshSpec(**spec_kw), (torch.device("cpu"),), rank=rank)


def _loss_inputs():
    rng = np.random.default_rng(7)
    vocab, e = 256, 32
    return dict(
        logits=rng.standard_normal((4, 8, vocab)).astype(np.float32) * 3,
        targets=rng.integers(0, vocab, (4, 8)).astype(np.int32),
        mask=(rng.random((4, 8)) > 0.2).astype(np.float32),
        x=rng.standard_normal((4, 8, e)).astype(np.float32),
        head=rng.standard_normal((e, vocab)).astype(np.float32) * 0.3,
    )


# ------------------------------------------------------------ rank programs


def _blocks(state):
    from ray_tpu_torch.util.tree import flatten

    return {path: leaf.detach().numpy().copy() for path, leaf in flatten(state)
            if isinstance(leaf, torch.Tensor)}


def _run_case(name, config):
    """Three steps of the case from JAX's initial state on this rank's
    rows, then the eval step: metrics, eval and the state's blocks."""
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.parallel import build_mesh, data_sharding
    from ray_tpu_torch.train import (
        default_optimizer, make_eval_step, make_train_step, train_state_from_numpy,
    )

    model, spec_kw, options = CASES[name]
    cfg = get_config(model)
    mesh = build_mesh(MeshSpec(**spec_kw), ["cpu"])
    opt = default_optimizer(LR, **_opt_kw(options))
    state = train_state_from_numpy(config["init"][name], cfg, mesh=mesh)
    step = make_train_step(cfg, opt, mesh=mesh, **_step_kw(options))
    local = {"tokens": data_sharding(mesh).shard(torch.from_numpy(_tokens(cfg.vocab_size)))}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = make_eval_step(cfg, mesh=mesh)(state, local)
    out = {"metrics": metrics, "eval": {k: float(v) for k, v in ev.items()},
           "blocks": _blocks(state), "stats": step.spmd.stats()}
    return mesh, cfg, state, out


def _rank4(config):
    """One rank of the gang of 4: the sharded forward, the vocab-parallel
    losses, every 4-rank step case, the checkpoint round trip, the
    explicit dp step's refusal, LMTrainer on its default mesh and the
    step's counted FLOPs."""
    import torch.distributed as dist

    from ray_tpu_torch.models import forward, get_config, logical_axes, params_from_numpy
    from ray_tpu_torch.ops.losses import cross_entropy_loss, fused_linear_cross_entropy
    from ray_tpu_torch.parallel import (
        ModelSharding, VocabShard, Wire, build_mesh, data_sharding, default_rules, shard_tree,
    )
    from ray_tpu_torch.train import (
        CheckpointManager, LMTrainer, default_optimizer, make_train_step, state_specs,
        train_state_from_numpy,
    )
    from ray_tpu_torch.util.tree import flatten

    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {"rank": rank}
    mesh = build_mesh(MeshSpec(fsdp=2, tp=2), ["cpu"])
    out["coords"] = mesh.coords

    # the sharded forward from JAX's init weights
    out["forward"] = {}
    for model in MODELS:
        cfg = get_config(model)
        params = shard_tree(params_from_numpy(config["fwd_params"][model], cfg, device="cpu",
                                              dtype=torch.float32),
                            logical_axes(cfg), default_rules(), mesh)
        spmd = ModelSharding(mesh, logical_axes(cfg))
        tokens = data_sharding(mesh).shard(torch.from_numpy(config["fwd_tokens"]))
        with torch.no_grad():
            out["forward"][model] = forward(params, tokens, cfg, spmd=spmd).numpy()

    # the feeds' placement of a batch: this rank's rows over (dp, fsdp)
    from ray_tpu_torch.data import from_numpy, lm_batch_iterator

    sharding = data_sharding(mesh)
    window = config["trainer_batches"][0]
    out["placed_lm"] = [b["tokens"].numpy() for b in lm_batch_iterator(
        types.SimpleNamespace(iter_blocks=lambda: iter([{"tokens": window.reshape(-1)}])),
        S, B, sharding=sharding)]
    ds = from_numpy({"x": np.arange(32).reshape(16, 2)}, num_blocks=2)
    out["placed_ds"] = [b["x"].numpy() for b in ds.iter_torch_batches(8, device="cpu",
                                                                       sharding=sharding)]

    # the vocab-parallel losses on this rank's slice of the vocabulary
    li = config["loss"]
    tp, tpi = mesh.shape["tp"], mesh.axis_index("tp")
    size = li["logits"].shape[-1] // tp
    vocab = VocabShard(tpi * size, Wire.for_axis(mesh, "tp"))
    cols = slice(tpi * size, (tpi + 1) * size)
    logits = torch.from_numpy(li["logits"][..., cols].copy()).requires_grad_(True)
    targets, mask = torch.from_numpy(li["targets"]), torch.from_numpy(li["mask"])
    loss, num = cross_entropy_loss(logits, targets, mask=mask, z_loss_coeff=1e-2, vocab=vocab)
    (g_logits,) = torch.autograd.grad(loss, [logits])
    x = torch.from_numpy(li["x"]).requires_grad_(True)
    head = torch.from_numpy(li["head"][:, cols].copy()).requires_grad_(True)
    floss, fnum = fused_linear_cross_entropy(x, head, targets, chunk=4, mask=mask,
                                             z_loss_coeff=1e-2, vocab=vocab)
    g_x, g_head = torch.autograd.grad(floss, [x, head])
    out["loss"] = dict(loss=loss.item(), num=num.item(), g_logits=g_logits.numpy(),
                       fused=floss.item(), fused_num=fnum.item(), g_x=g_x.numpy(),
                       g_head=g_head.numpy())

    # the step cases
    out["cases"] = {}
    for name in CASES4:
        case_mesh, cfg, state, out["cases"][name] = _run_case(name, config)
        if name == CKPT_CASE:
            specs = state_specs(state, cfg)
            mgr = CheckpointManager(config["ckpt_dir"], mesh=case_mesh)
            mgr.save(STEPS, state, specs=specs)
            fresh = train_state_from_numpy(config["init"][name], cfg, mesh=case_mesh)
            restored = mgr.restore(fresh, device="cpu")
            out["ckpt_bitwise"] = all(
                torch.equal(a, b) for (_, a), (_, b) in zip(flatten(state), flatten(restored))
                if isinstance(a, torch.Tensor))
            out["ckpt_scalars"] = (restored.step, restored.opt_state.count)
            mgr.close()

    out["legacy_ckpt"] = _legacy_dp_checkpoint(config["legacy_dir"])

    # the explicit dp step past pure dp
    cfg = get_config("gpt2-tiny")
    dp_mesh = build_mesh(MeshSpec(dp=2, fsdp=2), ["cpu"])
    out["explicit"] = []
    for flags in (dict(dp_shard_update=True), dict(dp_allreduce_dtype="int8")):
        try:
            make_train_step(cfg, default_optimizer(LR), mesh=dp_mesh, **flags)
            out["explicit"].append(None)
        except ValueError as exc:
            out["explicit"].append(str(exc))

    # LMTrainer on JAX's default mesh (fsdp = world size), from JAX's state
    trainer = LMTrainer(cfg, learning_rate=LR, total_steps=10, device="cpu")
    trainer.state = train_state_from_numpy(config["trainer_init"], cfg, mesh=trainer.mesh)
    reports = []
    trainer.train([{"tokens": t} for t in config["trainer_batches"]],
                  num_steps=len(config["trainer_batches"]), report_every=1,
                  report_fn=reports.append)
    out["trainer"] = dict(mesh=trainer.mesh.spec.describe(), num_params=trainer.num_params,
                          reports=[{k: r[k] for k in ("loss", "grad_norm", "num_tokens",
                                                       "tokens_per_sec")} for r in reports])
    # this rank's counted step at fsdp=2 x tp=2
    tp_trainer = LMTrainer(cfg, mesh_spec=MeshSpec(fsdp=2, tp=2), device="cpu")
    out["flops"] = tp_trainer.step_cost({"tokens": config["trainer_batches"][0]}).flops
    return out


def _legacy_dp_checkpoint(directory):
    """A dp=4 state with its moments in the rows layout (each rank's own
    row), after one step, saved by the gang; rank 0 then rewrites the
    step's index as a pure-dp gang wrote it before the index carried the
    mesh (layout {"ranks", "sharded"}) and re-commits it; each rank
    restores it. Returns whether the restore is bitwise and the layout's
    keys as read back."""
    import json

    import torch.distributed as dist

    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.parallel import build_mesh, data_sharding
    from ray_tpu_torch.train import (
        CheckpointManager, create_train_state, default_optimizer, make_train_step, state_specs,
    )
    from ray_tpu_torch.train.checkpoint import write_step_manifest
    from ray_tpu_torch.util.tree import flatten

    cfg, opt = get_config("gpt2-tiny"), default_optimizer(LR)
    mesh = build_mesh(MeshSpec(dp=4), ["cpu"])
    state = create_train_state(cfg, opt, 0, mesh=mesh, dp_shard_update=True)
    step = make_train_step(cfg, opt, mesh=mesh, dp_shard_update=True)
    state, _ = step(state, {"tokens": data_sharding(mesh).shard(
        torch.from_numpy(_tokens(cfg.vocab_size)))})
    mgr = CheckpointManager(directory, mesh=mesh)
    mgr.save(1, state, specs=state_specs(state, cfg, dp_shard_update=True))
    mgr.wait_until_finished()
    step_dir = os.path.join(directory, "1")
    dist.barrier()
    if dist.get_rank() == 0:
        with open(os.path.join(step_dir, "index.json")) as f:
            index = json.load(f)
        del index["layout"]["mesh"]
        with open(os.path.join(step_dir, "index.json"), "w") as f:
            json.dump(index, f)
        write_step_manifest(step_dir)
    dist.barrier()
    with open(os.path.join(step_dir, "index.json")) as f:
        keys = sorted(json.load(f)["layout"])
    fresh = create_train_state(cfg, opt, 1, mesh=mesh, dp_shard_update=True)
    restored = mgr.restore(fresh, device="cpu")
    mgr.close()
    bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten(state), flatten(restored))
                  if isinstance(a, torch.Tensor))
    row = sum(float(t.double().sum()) for _, t in flatten(restored.opt_state.mu))
    return {"bitwise": bitwise, "keys": keys, "row": row}


def _rank_sum(config):
    """A second run of the gang of 4: a fresh job whose all-reduce sums
    the ranks."""
    import torch.distributed as dist

    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(), "sum": float(x)}


def _rank8(config):
    """One rank of the gang of 8: the dp=2 x fsdp=2 x tp=2 case."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {"rank": dist.get_rank(), "cases": {}}
    for name in CASES8:
        out["cases"][name] = _run_case(name, config)[3]
    return out


# ------------------------------------------------------------- fixtures


def _plain_state(jstate):
    """A JAX TrainState as plain numpy namespaces (picklable without JAX)."""
    import jax

    from ray_tpu_torch.train.lm import _adam_state

    s = jax.tree.map(np.asarray, jstate)
    adam = _adam_state(s.opt_state)
    opt = types.SimpleNamespace(count=np.asarray(adam.count), mu=adam.mu, nu=adam.nu)
    return types.SimpleNamespace(step=np.asarray(s.step), params=s.params, opt_state=opt, ef=s.ef)


def _jax_mesh(spec_kw):
    import jax

    from ray_tpu.parallel import MeshSpec as JMeshSpec, build_mesh as jbuild_mesh

    n = int(np.prod(list(spec_kw.values())))
    return jbuild_mesh(JMeshSpec(**spec_kw), devices=jax.devices()[:n])


def _jax_init(name):
    """JAX's initial state of a case on its mesh, and what its step needs."""
    import jax

    from ray_tpu.models import get_config as jget_config
    from ray_tpu.train import create_train_state, default_optimizer

    model, spec_kw, options = CASES[name]
    cfg, mesh = jget_config(model), _jax_mesh(spec_kw)
    opt = default_optimizer(LR, **_opt_kw(options))
    state, sh = create_train_state(cfg, opt, jax.random.PRNGKey(0), mesh)
    return dict(cfg=cfg, mesh=mesh, opt=opt, state=state, sh=sh, init=_plain_state(state))


def _jax_steps(name, run):
    """JAX's GSPMD step of a case: 3 steps' metrics, the eval (where the
    case holds it) and the final state (global numpy arrays)."""
    from ray_tpu.train import make_eval_step, make_train_step

    cfg, mesh, state, sh = run["cfg"], run["mesh"], run["state"], run["sh"]
    step = make_train_step(cfg, run["opt"], mesh, state_shardings=sh, **_step_kw(CASES[name][2]))
    batch = {"tokens": _tokens(cfg.vocab_size)}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = make_eval_step(cfg, mesh, sh)(state, batch) if name in EVAL_CASES else {}
    return {"init": run["init"], "metrics": metrics, "state": _plain_state(state),
            "eval": {k: float(v) for k, v in ev.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs and the port's two gangs, overlapped: JAX's initial
    states first; then both gangs start (4 and 8 spawned gloo ranks, 120
    s timeouts) and run while JAX steps its cases and its LMTrainer over
    fsdp=8 (the 8 CPU devices). JAX's compiles run on 4 threads."""
    import jax

    from ray_tpu.models import get_config as jget_config
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.train import LMTrainer as JLMTrainer

    def jax_trainer():
        return JLMTrainer(jget_config("gpt2-tiny"), mesh_spec=JMeshSpec(fsdp=8),
                          learning_rate=LR, total_steps=10)

    with ThreadPoolExecutor(4) as pool:
        trainer_future = pool.submit(jax_trainer)
        inits = dict(zip(CASES, pool.map(_jax_init, CASES)))
        jtrainer = trainer_future.result()
    batches = [_tokens(256, seed=20 + i) for i in range(3)]
    ckpt_dir = str(tmp_path_factory.mktemp("fsdp_tp_ckpt"))
    fwd_params = {model: inits[name]["init"].params for name, (model, spec_kw, _) in CASES.items()
                  if spec_kw == dict(fsdp=2, tp=2)}
    config4 = {"init": {c: inits[c]["init"] for c in CASES4}, "fwd_params": fwd_params,
               "fwd_tokens": np.random.default_rng(6).integers(0, 256, (4, 16)).astype(np.int32),
               "loss": _loss_inputs(), "ckpt_dir": ckpt_dir,
               "legacy_dir": str(tmp_path_factory.mktemp("fsdp_tp_legacy_ckpt")),
               "trainer_init": jax.tree.map(np.asarray, jtrainer.state),
               "trainer_batches": batches}
    config8 = {"init": {c: inits[c]["init"] for c in CASES8}}
    gangs = []
    try:
        for n, program, config in ((4, _rank4, config4), (8, _rank8, config8)):
            group = MultihostWorkerGroup(n, run_name=f"fsdp-tp-{n}", backend="gloo",
                                         timeout_s=120)
            gangs.append(group)
            group.start()
            gangs[-1] = (group, group.run_async(program, config))
        out = {"ckpt_dir": ckpt_dir, "trainer_batches": batches, "trainer_reports": [],
               "fwd_params": fwd_params,
               "specs8": {n: jax.tree.map(lambda x: x.spec, inits[n]["sh"]) for n in CASES8},
               "jax_case": {n: (inits[n]["cfg"], inits[n]["mesh"], inits[n]["sh"]) for n in CASES}}
        with ThreadPoolExecutor(4) as pool:
            trained = pool.submit(jtrainer.train, [{"tokens": t} for t in batches], num_steps=3,
                                  report_every=1, report_fn=out["trainer_reports"].append)
            out["jax"] = dict(zip(CASES, pool.map(lambda n: _jax_steps(n, inits[n]), CASES)))
            trained.result()
        for n, (group, refs) in zip((4, 8), gangs):
            out[n] = group.finish(refs, timeout=240)
            assert [r["rank"] for r in out[n]] == list(range(n))
        group = gangs[0][0]
        out["again"] = group.finish(group.run_async(_rank_sum, {}), timeout=240)
    finally:
        for g in gangs:
            (g[0] if isinstance(g, tuple) else g).shutdown()
    return out


# -------------------------------------------------------------------- tests


def test_state_specs_match_jax(runs):
    """The port's state specs equal JAX's state shardings at dp=2 x
    fsdp=2 x tp=2 (JAX's tests/test_train.py, llama-tiny): every param
    and both Adam moments carry the rule's spec, the counts are
    replicated."""
    import jax

    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.train import create_train_state, default_optimizer, state_specs
    from ray_tpu_torch.train.lm import _adam_state

    name = CASES8[0]
    model = CASES[name][0]
    jspecs = runs["specs8"][name]
    specs = state_specs(create_train_state(get_config(model), default_optimizer(1e-3),
                                           device="cpu"), get_config(model))
    jadam = _adam_state(jspecs.opt_state)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for tree, prefix in ((jspecs.params, "params"), (jadam.mu, "opt_state/mu"),
                         (jadam.nu, "opt_state/nu")):
        for path, spec in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]:
            key = prefix + "/" + "/".join(k.key for k in path)
            assert tuple(specs[key]) == tuple(spec), key
    assert tuple(specs["opt_state/mu/blocks/w_up"]) == (None, "fsdp", "tp")
    assert tuple(jspecs.step) == ()
    assert not any(k.startswith(("step", "opt_state/count")) for k in specs)


def test_vocab_split_that_does_not_divide_raises_like_jax():
    """GPT-2's vocabulary of 50257 does not divide by tp = 2: the port's
    placement raises ValueError, as JAX's device_put does; with the
    vocabulary kept whole it places."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding as JNamedSharding, PartitionSpec as JP

    from ray_tpu_torch.models import get_config, logical_axes
    from ray_tpu_torch.parallel import default_rules, override_rules, shard_tree

    wte = np.zeros((50257, 8), np.float32)
    with pytest.raises(ValueError):
        jax.device_put(jnp.asarray(wte), JNamedSharding(_jax_mesh(dict(tp=2)), JP("tp", None)))
    axes = {"wte": logical_axes(get_config("gpt2-small"))["wte"]}
    mesh = _mesh(dict(tp=2), rank=1)
    with pytest.raises(ValueError, match="50257"):
        shard_tree({"wte": torch.from_numpy(wte)}, axes, default_rules(), mesh)
    kept = shard_tree({"wte": torch.from_numpy(wte)}, axes,
                      override_rules(default_rules(), vocab=None), mesh)
    assert kept["wte"].shape == (50257, 8)


@pytest.mark.parametrize("model", MODELS)
def test_sharded_forward_matches_jax(model, runs):
    """The forward at fsdp=2 x tp=2 from the same converted weights (JAX's
    tests/test_models.py::test_sharded_forward_on_mesh): each rank's
    logits are its rows and vocabulary columns of JAX's."""
    import jax

    from ray_tpu._jax_compat import set_mesh
    from ray_tpu.models import forward as jforward, get_config as jget_config, \
        logical_axes as jlogical_axes
    from ray_tpu.parallel import default_rules as jdefault_rules, shard_tree as jshard_tree

    cfg = jget_config(model)
    mesh = _jax_mesh(dict(fsdp=2, tp=2))
    params = jshard_tree(jax.tree.map(jax.numpy.asarray, runs["fwd_params"][model]),
                         jlogical_axes(cfg), jdefault_rules(), mesh)
    tokens = np.random.default_rng(6).integers(0, 256, (4, 16)).astype(np.int32)
    with set_mesh(mesh):
        ref = np.asarray(jax.jit(lambda p, t: jforward(p, t, cfg))(params, tokens))
    blocks = [r["forward"][model] for r in runs[4]]
    got = NamedSharding(_mesh(dict(fsdp=2, tp=2)), P(("dp", "fsdp"), None, "tp")).assemble(blocks)
    np.testing.assert_allclose(got, ref, **TOL)


def test_a_gang_runs_functions_in_turn(runs):
    """The gang of 4 runs a second function after its first: each run is
    a torch.distributed job of its own (its rendezvous under a prefix of
    its own), so the second one's all-reduce sees every rank."""
    assert [(r["rank"], r["world"], r["sum"]) for r in runs["again"]] == \
        [(rank, 4, 10.0) for rank in range(4)]


def test_batch_feeds_place_rows_over_the_data_axes(runs):
    """lm_batch_iterator(sharding=) and iter_torch_batches(sharding=) on
    fsdp=2 x tp=2 give each rank its rows over (dp, fsdp), the same on
    both tp ranks of a row block (JAX's `data_sharding`)."""
    window = runs["trainer_batches"][0]
    rows = np.arange(32).reshape(16, 2)
    for r in runs[4]:
        f = r["coords"]["fsdp"]
        assert len(r["placed_lm"]) == 1
        np.testing.assert_array_equal(r["placed_lm"][0], window[4 * f:4 * f + 4])
        assert len(r["placed_ds"]) == 2
        for i, batch in enumerate(r["placed_ds"]):
            np.testing.assert_array_equal(batch, rows[8 * i + 4 * f:8 * i + 4 * f + 4])


def test_vocab_parallel_losses_match_jax(runs):
    """cross_entropy_loss and fused_linear_cross_entropy over a vocabulary
    split on tp (with a mask and z-loss) equal JAX's unsharded losses;
    each rank's logit / head gradient is its columns of JAX's, and the
    hidden states' gradients, summed over the tp ranks, are JAX's."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.losses import cross_entropy_loss as jce, fused_linear_cross_entropy as jfce

    li = _loss_inputs()
    targets, mask = jnp.asarray(li["targets"]), jnp.asarray(li["mask"])
    (jl, jn), jg = jax.value_and_grad(lambda lg: jce(lg, targets, mask=mask, z_loss_coeff=1e-2),
                                      has_aux=True)(jnp.asarray(li["logits"]))
    (jf, jfn), (jgx, jgh) = jax.value_and_grad(
        lambda x, h: jfce(x, h, targets, chunk=4, mask=mask, z_loss_coeff=1e-2),
        argnums=(0, 1), has_aux=True)(jnp.asarray(li["x"]), jnp.asarray(li["head"]))
    size = li["logits"].shape[-1] // 2
    gx = {}
    for r in runs[4]:
        out, tpi = r["loss"], r["coords"]["tp"]
        cols = slice(tpi * size, (tpi + 1) * size)
        np.testing.assert_allclose(out["loss"], float(jl), **TOL)
        np.testing.assert_allclose(out["fused"], float(jf), **TOL)
        assert out["num"] == out["fused_num"] == float(jn) == float(jfn)
        np.testing.assert_allclose(out["g_logits"], np.asarray(jg)[..., cols], **TOL)
        np.testing.assert_allclose(out["g_head"], np.asarray(jgh)[:, cols], **TOL)
        gx[tpi] = out["g_x"]
    np.testing.assert_allclose(gx[0] + gx[1], np.asarray(jgx), **TOL)


def _check_case(name, runs, n):
    model, spec_kw, options = CASES[name]
    ref, ranks = runs["jax"][name], runs[n]
    for r in ranks:
        run = r["cases"][name]
        for i, (jm, tm) in enumerate(zip(ref["metrics"], run["metrics"])):
            assert tm["num_tokens"] == jm["num_tokens"] == B * S
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(tm[key], jm[key], **TOL, err_msg=f"{name} {key} {i}")
        if name in EVAL_CASES:
            np.testing.assert_allclose(run["eval"]["eval_loss"], ref["eval"]["eval_loss"], **TOL)
            assert run["eval"]["num_tokens"] == ref["eval"]["num_tokens"] == B * S
    if "grad_clip" in options:
        assert ref["metrics"][0]["grad_norm"] > options["grad_clip"]  # the clip acts
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.train import create_train_state, default_optimizer, state_specs

    specs = state_specs(create_train_state(get_config(model), default_optimizer(LR),
                                           device="cpu"), get_config(model))
    mesh = _mesh(spec_kw)
    state = ref["state"]
    for tree, prefix in ((state.params, "params"), (state.opt_state.mu, "opt_state/mu"),
                         (state.opt_state.nu, "opt_state/nu")):
        for key, want in _numpy_items(tree, prefix):
            got = NamedSharding(mesh, specs[key]).assemble(
                [r["cases"][name]["blocks"][key] for r in ranks])
            np.testing.assert_allclose(got, want, **STATE_TOL, err_msg=f"{name} {key}")
    return ranks[0]["cases"][name]["stats"]


def _numpy_items(tree, prefix):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _numpy_items(value, f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", np.asarray(value)


@pytest.mark.parametrize("name", CASES4)
def test_sharded_step_matches_jax(name, runs):
    """3 steps and the eval step on a mesh of 4 ranks against JAX's GSPMD
    step on the same mesh: every rank's loss, grad norm and token count,
    the eval loss, and every parameter and Adam moment reassembled from
    the blocks. The step's collectives are those of its axes."""
    stats = _check_case(name, runs, 4)
    model, spec_kw, options = CASES[name]
    if "fsdp" in spec_kw:
        # ZeRO-3: the backward runs each layer again, its gather included
        # (one collective a layer), besides the forward's gathers, each of
        # which has its reduce-scatter
        from ray_tpu_torch.models import get_config

        again = STEPS * options.get("grad_accum", 1) * get_config(model).n_layers
        assert stats["fsdp_gather"]["calls"] == stats["fsdp_scatter"]["calls"] + again
    for axis in spec_kw:
        labels = {"dp": ["dp_sync"], "fsdp": ["fsdp_gather", "fsdp_scatter"],
                  "tp": ["tp_allreduce"]}[axis]
        for label in labels:
            assert stats[label]["calls"] > 0 and stats[label]["bytes"] > 0, (name, label)


@pytest.mark.parametrize("name", CASES8)
def test_dp_fsdp_tp_step_and_eval_match_jax(name, runs):
    """dp=2 x fsdp=2 x tp=2 on 8 ranks (JAX's tests/test_train.py mesh):
    make_train_step and make_eval_step against JAX's."""
    stats = _check_case(name, runs, 8)
    for label in ("dp_sync", "fsdp_gather", "fsdp_scatter", "fsdp_sync", "tp_allreduce"):
        assert stats[label]["calls"] > 0, label


def test_checkpoint_round_trip_on_the_mesh(runs):
    """The fsdp=2 x tp=2 state saved by its 4 ranks: each distinct block
    is written once (by the rank at 0 on the axes outside its spec), a
    restore on the same mesh is bitwise on every rank, and the blocks put
    together (`read_global`) are the ranks' blocks assembled, which match
    JAX's state."""
    from ray_tpu_torch.train import read_global, verify_step_dir
    import json

    assert all(r["ckpt_bitwise"] for r in runs[4])
    assert all(r["ckpt_scalars"] == (STEPS, STEPS) for r in runs[4])
    step_dir = os.path.join(runs["ckpt_dir"], str(STEPS))
    assert verify_step_dir(step_dir) is None
    with open(os.path.join(step_dir, "index.json")) as f:
        layout = json.load(f)["layout"]
    written = {}
    for rank in range(4):
        path = os.path.join(step_dir, f"rank{rank}.json")
        if os.path.exists(path):
            with open(path) as f:
                for leaf in json.load(f)["tensors"]:
                    written[leaf] = written.get(leaf, 0) + 1
    assert set(written) == set(layout["sharded"])
    for leaf, entry in layout["sharded"].items():
        blocks = 1
        for e in entry["spec"]:
            for a in ([e] if isinstance(e, str) else e or []):
                blocks *= layout["mesh"][a]
        assert written[leaf] == blocks, leaf
    saved = read_global(step_dir)
    mesh = _mesh(CASES[CKPT_CASE][1])
    for key, entry in layout["sharded"].items():
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in entry["spec"]])
        want = NamedSharding(mesh, spec).assemble(
            [r["cases"][CKPT_CASE]["blocks"][key] for r in runs[4]])
        np.testing.assert_array_equal(saved[key], want)
    jparams = dict(_numpy_items(runs["jax"][CKPT_CASE]["state"].params, "params"))
    for key, want in jparams.items():
        np.testing.assert_allclose(saved[key], want, **STATE_TOL, err_msg=key)


def test_pure_dp_checkpoint_without_its_mesh_restores(runs):
    """A pure-dp gang's checkpoint whose index has no mesh (the layout
    {"ranks", "sharded"} that gangs wrote before fsdp / tp) restores on
    its dp=4 mesh, bitwise on every rank, each rank reading its own row
    of the rows-layout moments."""
    for r in runs[4]:
        legacy = r["legacy_ckpt"]
        assert legacy["keys"] == ["ranks", "sharded"]
        assert legacy["bitwise"], r["rank"]
    assert len({r["legacy_ckpt"]["row"] for r in runs[4]}) == 4


def test_explicit_dp_step_raises_past_pure_dp(runs):
    """The explicit dp step (sharded update, int8 all-reduce) needs a
    pure-dp mesh: on dp=2 x fsdp=2 it raises ValueError, as JAX's does."""
    from ray_tpu.train import default_optimizer as jdefault, make_train_step as jmake

    cfg, mesh, sh = runs["jax_case"]["gpt2 dp2 fsdp2"]
    for flags in (dict(dp_shard_update=True), dict(dp_allreduce_dtype="int8")):
        with pytest.raises(ValueError, match="pure-dp mesh"):
            jmake(cfg, jdefault(LR), mesh, state_shardings=sh, **flags)
    for r in runs[4]:
        for msg in r["explicit"]:
            assert msg is not None and "pure-dp mesh" in msg and "fsdp" in msg


def test_lm_trainer_default_mesh_is_fsdp_over_the_gang(runs):
    """A bare LMTrainer in a gang of 4 takes JAX's default mesh, fsdp = 4,
    and trains from JAX's trainer state as JAX's trainer does (its own
    default over the 8 CPU devices is fsdp = 8; the math is the same):
    losses and grad norms per step, the global batch's tokens, and the
    model's full parameter count."""
    from ray_tpu_torch.models import count_params, get_config, init_params

    n_params = count_params(init_params(get_config("gpt2-tiny"), device="cpu"))
    for r in runs[4]:
        out = r["trainer"]
        assert out["mesh"] == "fsdp=4" and out["num_params"] == n_params
        assert len(out["reports"]) == len(runs["trainer_reports"]) == 3
        for jr, tr in zip(runs["trainer_reports"], out["reports"]):
            for key in ("loss", "grad_norm", "num_tokens"):
                np.testing.assert_allclose(tr[key], jr[key], **STATE_TOL, err_msg=key)
            assert tr["num_tokens"] == B * S and tr["tokens_per_sec"] > 0


def test_step_cost_counts_this_ranks_work(runs):
    """util/profiling.step_cost of a rank's fsdp=2 x tp=2 step counts its
    rows, heads, hidden units and vocabulary columns: the 4 ranks' FLOPs
    sum to the one-device count of the same global batch."""
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.train import LMTrainer

    tokens = runs["trainer_batches"][0]
    one = LMTrainer(get_config("gpt2-tiny"), device="cpu").step_cost({"tokens": tokens}).flops
    per_rank = [r["flops"] for r in runs[4]]
    assert len(set(per_rank)) == 1
    assert sum(per_rank) == one
