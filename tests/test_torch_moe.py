"""The MoE model of ray_tpu_torch (`models/moe.py`) against the JAX package
on the CPU.

One process: routing (`topk_dispatch`, the capacity drops, the aux loss),
the forward's logits and aux, the gradient of `moe_loss` and the
parameter and logical-axis trees, all from JAX's `moe_tiny` initial
parameters carried with `params_from_numpy` and numpy inputs made from
seeds. Expert parallelism: a gang of 4 spawned gloo ranks
(`MultihostWorkerGroup`, 120 s timeouts) on `MeshSpec(dp=2, ep=2)`, each
rank holding 2 of the 4 experts and its dp rows of the batch, against
JAX's gradient of `moe_loss` on its dp=2 x ep=2 mesh of 4 CPU devices
(`tests/test_moe.py`'s sharded run). The rank program is module-level.

Router probabilities from random f32 inputs have no ties, so
`jax.lax.top_k` and `torch.topk` pick the same experts in the same order.

Tolerances (f32): dispatch exact; combine, the aux loss, logits and the
loss at atol = rtol = 1e-5; gradients at atol = rtol = 1e-4 (JAX's
einsums sum the experts in another order).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import moe
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.parallel.mesh import Mesh, NamedSharding
from ray_tpu_torch.train.multihost import MultihostWorkerGroup
from ray_tpu_torch.util.tree import flatten

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 4, 16


def _tokens(vocab, seed=3, rows=B):
    return np.random.default_rng(seed).integers(0, vocab, (rows, S + 1)).astype(np.int32)


def _probs(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    import jax

    from ray_tpu.models import moe as jmoe

    config = jmoe.moe_tiny()
    params = jmoe.init_params(config, jax.random.PRNGKey(0))
    return config, params, jax.tree.map(np.asarray, params)


def _port_params(np_params):
    return params_from_numpy(np_params, moe.moe_tiny(), device="cpu", dtype=torch.float32)


# ------------------------------------------------------------- one process


def test_configs_match_jax():
    from ray_tpu.models import moe as jmoe

    for name in ("mixtral_8x7b", "moe_tiny"):
        mine, ref = getattr(moe, name)(), getattr(jmoe, name)()
        for field in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
                      "max_seq", "pos_emb", "norm", "act", "use_bias", "tie_embeddings",
                      "rope_theta", "remat", "n_experts", "top_k", "capacity_factor",
                      "router_aux_coeff"):
            assert getattr(mine, field) == getattr(ref, field), (name, field)


@pytest.mark.parametrize("top_k,capacity", [(2, 16), (2, 5), (1, 3)])
def test_topk_dispatch_matches_jax(top_k, capacity):
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe

    probs = _probs(1, (2, 16, 4))
    d, c = moe.topk_dispatch(torch.from_numpy(probs), top_k, capacity)
    jd, jc = jmoe.topk_dispatch(jnp.asarray(probs), top_k, capacity)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    # the aux loss on the same routing
    aux = moe.load_balancing_loss(torch.from_numpy(probs), d)
    np.testing.assert_allclose(aux.item(), float(jmoe.load_balancing_loss(jnp.asarray(probs), jd)),
                               **TOL)


def test_capacity_drops_match_jax():
    """Every token wants expert 0: only `capacity` survive, the same ones."""
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe

    probs = np.zeros((1, 8, 4), np.float32)
    probs[:, :, 0] = 1.0
    d, _ = moe.topk_dispatch(torch.from_numpy(probs), 1, 3)
    jd, _ = jmoe.topk_dispatch(jnp.asarray(probs), 1, 3)
    assert float(d.sum()) == 3.0
    assert np.array_equal(d.numpy(), np.asarray(jd))


def test_param_and_axes_trees_match_jax(jax_model):
    import jax

    from ray_tpu.models import moe as jmoe

    config, _, np_params = jax_model
    mine = moe.init_params(moe.moe_tiny(), 0, device="cpu")
    assert {p: tuple(t.shape) for p, t in flatten(mine)} == \
        {p: tuple(v.shape) for p, v in flatten(np_params)}
    axes = moe.logical_axes(moe.moe_tiny())
    jaxes = jmoe.logical_axes(config)
    flat = jax.tree_util.tree_flatten_with_path(jaxes, is_leaf=lambda x: isinstance(x, tuple))[0]
    want = {"/".join(str(k.key) for k in path): tuple(leaf) for path, leaf in flat}
    got = {}
    for key, value in axes.items():
        if isinstance(value, dict):
            got.update({f"{key}/{k}": tuple(v) for k, v in value.items()})
        else:
            got[key] = tuple(value)
    assert got == want
    assert set(got) == {p for p, _ in flatten(mine)}


def test_forward_matches_jax(jax_model):
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe

    config, params, np_params = jax_model
    tokens = _tokens(config.vocab_size)[:, :-1]
    logits, aux = jmoe.forward(params, jnp.asarray(tokens), config)
    with torch.no_grad():
        got, got_aux = moe.forward(_port_params(np_params), torch.from_numpy(tokens),
                                   moe.moe_tiny())
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_allclose(got_aux.item(), float(aux), **TOL)


def test_loss_and_gradient_match_jax(jax_model):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe

    config, params, np_params = jax_model
    tokens = _tokens(config.vocab_size)
    (loss, (ce, aux, ntok)), grads = jax.value_and_grad(
        lambda p: jmoe.moe_loss(p, jnp.asarray(tokens), config), has_aux=True)(params)
    mine = _port_params(np_params)
    paths, leaves = zip(*flatten(mine))
    for t in leaves:
        t.requires_grad_()
    got, (got_ce, got_aux, got_n) = moe.moe_loss(mine, torch.from_numpy(tokens), moe.moe_tiny())
    got_grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(loss), **TOL)
    np.testing.assert_allclose([got_ce.item(), got_aux.item(), got_n.item()],
                               [float(ce), float(aux), float(ntok)], **TOL)
    want = dict(flatten(jax.tree.map(np.asarray, grads)))
    for path, g in zip(paths, got_grads):
        np.testing.assert_allclose(g.numpy(), want[path], err_msg=path, **GRAD_TOL)
    # the router and the experts get gradients
    assert float(want["blocks/router"].std()) > 0 and float(want["blocks/we_up"].std()) > 0


# ------------------------------------------------------- expert parallel


def _ep_rank(config):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import (
        ModelSharding, build_mesh, data_sharding, default_rules, shard_tree,
    )

    torch.set_num_threads(1)
    cfg = moe.moe_tiny()
    mesh = build_mesh(MeshSpec(dp=2, ep=2), ["cpu"])
    full = params_from_numpy(config["params"], cfg, device="cpu", dtype=torch.float32)
    params = shard_tree(full, moe.logical_axes(cfg), default_rules(), mesh)
    paths, leaves = zip(*flatten(params))
    for t in leaves:
        t.requires_grad_()
    spmd = ModelSharding(mesh, moe.logical_axes(cfg))
    rows = data_sharding(mesh).shard(torch.from_numpy(config["tokens"]))
    loss, (ce, aux, ntok) = moe.moe_loss(params, rows, cfg, spmd=spmd)
    grads = list(torch.autograd.grad(loss, leaves))
    spmd.sync_grads(list(paths), grads)
    with torch.no_grad():
        logits, fwd_aux = moe.forward(params, rows[:, :-1], cfg, spmd=spmd)
    return dict(rank=dist.get_rank(), coords=mesh.coords, split=dict(spmd.split),
                experts=spmd.expert_range(cfg.n_experts), loss=loss.item(), ce=ce.item(),
                aux=aux.item(), ntok=ntok.item(), logits=logits.numpy(), fwd_aux=fwd_aux.item(),
                grads={p: g.numpy() for p, g in zip(paths, grads)},
                shapes={p: tuple(t.shape) for p, t in zip(paths, leaves)})


@pytest.fixture(scope="module")
def ep_run(jax_model):
    """The gang of 4 runs while JAX computes its dp=2 x ep=2 gradient."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe
    from ray_tpu.parallel import (
        MeshSpec as JMeshSpec, build_mesh as jbuild_mesh, default_rules as jrules,
        shard_tree as jshard_tree,
    )

    config, params, np_params = jax_model
    tokens = _tokens(config.vocab_size, seed=5)
    group = MultihostWorkerGroup(4, run_name="moe-ep", backend="gloo", timeout_s=120)
    try:
        group.start()
        refs = group.run_async(_ep_rank, {"params": np_params, "tokens": tokens})
        mesh = jbuild_mesh(JMeshSpec(dp=2, ep=2), devices=jax.devices()[:4])
        sharded = jshard_tree(params, jmoe.logical_axes(config), jrules(), mesh)
        assert sharded["blocks"]["we_up"].sharding.spec[1] == "ep"
        (loss, (ce, aux, _)), grads = jax.jit(jax.value_and_grad(
            lambda p, t: jmoe.moe_loss(p, t, config), has_aux=True))(sharded, jnp.asarray(tokens))
        logits, fwd_aux = jax.jit(lambda p, t: jmoe.forward(p, t, config))(
            sharded, jnp.asarray(tokens[:, :-1]))
        out = dict(loss=float(loss), ce=float(ce), aux=float(aux), logits=np.asarray(logits),
                   fwd_aux=float(fwd_aux), grads=dict(flatten(jax.tree.map(np.asarray, grads))),
                   ranks=group.finish(refs, timeout=240))
    finally:
        group.shutdown()
    assert [r["rank"] for r in out["ranks"]] == list(range(4))
    return out


def _leaf_specs(logical, rules, mesh):
    """(mesh, {leaf path: PartitionSpec}) by the rules."""
    from ray_tpu_torch.parallel.sharding import tree_specs
    from ray_tpu_torch.parallel.spmd import dict_items

    return mesh, dict(dict_items(tree_specs(logical, rules)))


def test_dp_ep_ranks_hold_their_experts(ep_run):
    for r in ep_run["ranks"]:
        ep = r["coords"]["ep"]
        assert r["split"]["expert"] and not r["split"]["mlp"] and not r["split"]["attn"]
        assert tuple(r["experts"]) == (2 * ep, 2 * ep + 2)
        assert r["shapes"]["blocks/we_up"][1] == 2
        assert r["shapes"]["blocks/router"] == (4, 64, 4)


def test_dp_ep_loss_and_forward_match_jax(ep_run):
    """The loss is the global batch's on every rank (the CE's token mean
    and the aux over both dp ranks' rows); the logits are the rank's
    rows."""
    for r in ep_run["ranks"]:
        np.testing.assert_allclose([r["loss"], r["ce"], r["aux"]],
                                   [ep_run["loss"], ep_run["ce"], ep_run["aux"]], **TOL)
        assert r["ntok"] == B * S
        dp = r["coords"]["dp"]
        rows = slice(dp * B // 2, (dp + 1) * B // 2)
        np.testing.assert_allclose(r["logits"], ep_run["logits"][rows], **TOL)
        np.testing.assert_allclose(r["fwd_aux"], ep_run["fwd_aux"], **TOL)


def test_dp_ep_gradient_matches_jax(ep_run):
    """Every leaf's gradient, router included, put back together from the
    ranks' blocks, against JAX's dp x ep gradient."""
    from ray_tpu_torch.parallel import default_rules

    mesh, specs = _leaf_specs(moe.logical_axes(moe.moe_tiny()), default_rules(),
                              Mesh(MeshSpec(dp=2, ep=2), (torch.device("cpu"),)))
    ranks = ep_run["ranks"]
    for path, want in ep_run["grads"].items():
        got = NamedSharding(mesh, specs[path]).assemble([r["grads"][path] for r in ranks])
        np.testing.assert_allclose(got, want, err_msg=path, **GRAD_TOL)
        # the replicated leaves' gradients are equal on every rank
        if "ep" not in str(specs[path]):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r["grads"][path], ranks[0]["grads"][path])
    assert float(np.abs(ep_run["grads"]["blocks/router"]).max()) > 0
