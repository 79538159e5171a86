"""ray_tpu_torch.train and ray_tpu_torch.ops.losses against the JAX
package on the CPU.

The same numpy inputs (and, for the train step, the JAX init's weights
carried over as f32 masters with `params_from_numpy`) go through both.
On the CPU the port's step takes the flash backward's plain version; the
JAX step on the CPU takes its XLA reference attention.

Tolerances: losses, their gradients and the optimizer at atol = rtol =
1e-5 (f32 sums in another order); the train step's losses, grad norms and
final parameters at atol = rtol = 1e-4 (f32 through four layers and a few
Adam updates, which divide small moments by their square roots).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import models as jmodels
from ray_tpu.ops import losses as jlosses
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import lm as jlm
from ray_tpu_torch import ops as tops
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.ops import losses as tlosses
from ray_tpu_torch.train import (
    create_train_state,
    default_optimizer,
    loss_and_grads,
    make_eval_step,
    make_train_step,
    tree_leaves,
)

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast as many and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.detach().numpy(), **(tol or TOL))


# -------------------------------------------------------------------- losses


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_coeff", [0.0, 1e-3])
def test_cross_entropy_value_and_grad_match_jax(masked, z_coeff):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 9, 37))).astype(np.float32)
    targets = rng.integers(0, 37, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None

    def jloss(lg):
        m = None if mask is None else jnp.asarray(mask)
        return jlosses.cross_entropy_loss(lg, jnp.asarray(targets), mask=m, z_loss_coeff=z_coeff)

    (jl, jn), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    tl = _t(logits).requires_grad_()
    loss, num = tlosses.cross_entropy_loss(
        tl, _t(targets), mask=None if mask is None else _t(mask), z_loss_coeff=z_coeff)
    loss.backward()
    _close(jl, loss)
    _close(jn, num)
    _close(jg, tl.grad)
    _close(jlosses.z_loss(jnp.asarray(logits)), tlosses.z_loss(_t(logits)))


@pytest.mark.parametrize("masked", [False, True])
def test_fused_linear_cross_entropy_matches_jax(masked):
    """The chunked head + loss (4 chunks of 8) against JAX's scan, value and
    gradients for the hidden states and the head."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    head = (0.3 * rng.standard_normal((16, 41))).astype(np.float32)
    targets = rng.integers(0, 41, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) > 0.25).astype(np.float32) if masked else None

    def jloss(x_, h_):
        m = None if mask is None else jnp.asarray(mask)
        return jlosses.fused_linear_cross_entropy(
            x_, h_, jnp.asarray(targets), chunk=8, mask=m, z_loss_coeff=1e-3)

    (jl, jn), (jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(head))
    tx, th = _t(x).requires_grad_(), _t(head).requires_grad_()
    loss, num = tlosses.fused_linear_cross_entropy(
        tx, th, _t(targets), chunk=8, mask=None if mask is None else _t(mask), z_loss_coeff=1e-3)
    loss.backward()
    _close(jl, loss)
    _close(jn, num)
    _close(jgx, tx.grad)
    _close(jgh, th.grad)
    with pytest.raises(ValueError, match="not divisible"):
        tlosses.fused_linear_cross_entropy(tx, th, _t(targets), chunk=7)


@pytest.mark.parametrize("case", [
    (8, 1024, 50257, 80 * 2**30),   # GPT-2 124M on one H100: dense
    (32, 1024, 50257, 16 * 2**30),  # over 80% of 16 GiB: chunked
    (4, 1000, 128256, 8 * 2**30),   # no candidate divides S: dense
    (4, 384, 128256, 2 * 2**30),    # 512 does not divide, 128 does
    (4, 1024, 50257, 0),            # unknown memory: dense
])
def test_auto_loss_chunk_matches_jax(case):
    b, s, v, hbm = case
    assert tlosses.auto_loss_chunk(b, s, v, hbm) == jlosses.auto_loss_chunk(b, s, v, hbm)
    assert tlosses.auto_loss_chunk(b, s, v, device="cpu") == 0


# ----------------------------------------------------------------- optimizer


@pytest.mark.parametrize("grad_clip", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_default_optimizer_matches_optax(grad_clip):
    """5 updates on the same numpy gradients: warmup (lr(0) = 0, so the
    first update moves only the moments), then cosine decay; decoupled
    weight decay on every leaf."""
    rng = np.random.default_rng(2)
    shapes = {"w": (5, 3), "blocks": {"a": (4,), "b": (2, 2, 3)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple)) for _ in range(5)]
    jopt = jlm.default_optimizer(0.1, warmup_steps=2, total_steps=4, weight_decay=0.1,
                                 grad_clip=grad_clip)
    topt = default_optimizer(0.1, warmup_steps=2, total_steps=4, weight_decay=0.1,
                             grad_clip=grad_clip)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = jax.tree.map(_t, params)  # dicts in JAX's leaf order
    tstate = topt.init(tparams)
    for i, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = [_t(x) for x in jax.tree.leaves(g)]
        tstate = topt.update(tg, tstate, tparams)
        for jl, tl in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
            _close(jl, tl)
        if i == 0:  # lr(0) = 0
            for x, tl in zip(jax.tree.leaves(params), tree_leaves(tparams)):
                np.testing.assert_array_equal(x, tl.numpy())
    assert tstate.count == 5


# ---------------------------------------------------------------- train step


def _jax_state(name, opt):
    config = jmodels.get_config(name)
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    state, shardings = jlm.create_train_state(config, opt, jax.random.PRNGKey(0), mesh)
    return config, mesh, state, shardings


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_train_step_matches_jax(name):
    """Four steps of both train steps from the same f32 weights on the same
    tokens: per-step loss and grad_norm, then every final parameter; the
    eval step on the trained weights too."""
    steps, lr = 4, 1e-2
    jopt = jlm.default_optimizer(lr, warmup_steps=1, total_steps=steps)
    jconfig, mesh, jstate, shardings = _jax_state(name, jopt)
    tconfig = tmodels.get_config(name)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jstate.params), tconfig,
                                device="cpu", dtype=torch.float32)
    topt = default_optimizer(lr, warmup_steps=1, total_steps=steps)
    tstate = create_train_state(tconfig, topt, params=tparams, device="cpu")
    assert tparams["wte"].dtype == torch.float32
    jstep = jlm.make_train_step(jconfig, jopt, mesh, state_shardings=shardings)
    tstep = make_train_step(tconfig, topt, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(steps):
        tokens = rng.integers(0, jconfig.vocab_size, (4, 17)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {"tokens": _t(tokens)})
        for key in ("loss", "grad_norm", "num_tokens"):
            _close(jm[key], tm[key], **STEP_TOL)
    assert tstate.step == steps == int(jstate.step)
    jleaves = jax.tree.leaves(jstate.params)
    tleaves = tree_leaves(tstate.params)
    assert len(jleaves) == len(tleaves)
    for jl, tl in zip(jleaves, tleaves):
        _close(jl, tl, **STEP_TOL)
    tokens = rng.integers(0, jconfig.vocab_size, (2, 17)).astype(np.int32)
    jeval = jlm.make_eval_step(jconfig, mesh, shardings)(jstate, {"tokens": jnp.asarray(tokens)})
    teval = make_eval_step(tconfig, device="cpu")(tstate, {"tokens": _t(tokens)})
    _close(jeval["eval_loss"], teval["eval_loss"], **STEP_TOL)
    # the CPU step took the plain versions: no kernel launched
    assert all(k.launches == 0 for k in tops.KERNELS)


def test_grad_accum_remat_and_loss_chunk_match_the_plain_step():
    """grad_accum=2 against the big batch, remat against no remat, and the
    fused chunked loss against the dense loss, on the same gpt2-tiny
    weights."""
    config = tmodels.get_config("gpt2-tiny")
    params = tmodels.init_params(config, 0, device="cpu")
    params = {k: ({kk: vv.requires_grad_() for kk, vv in v.items()} if k == "blocks"
                  else v.requires_grad_()) for k, v in params.items()}
    tokens = _t(np.random.default_rng(4).integers(0, config.vocab_size, (4, 17)))
    base_loss, base_ntok, base = loss_and_grads(config, params, tokens, loss_chunk=0)
    variants = {
        "grad_accum": (config, dict(grad_accum=2, loss_chunk=0)),
        "remat": (config.replace(remat=True), dict(loss_chunk=0)),
        "loss_chunk": (config, dict(loss_chunk=8)),
    }
    for label, (cfg, kw) in variants.items():
        loss, ntok, grads = loss_and_grads(cfg, params, tokens, **kw)
        torch.testing.assert_close(loss, base_loss, **TOL, msg=label)
        assert float(ntok) == float(base_ntok) == 4 * 16, label
        for g, b in zip(grads, base):
            torch.testing.assert_close(g, b, **TOL, msg=label)
    with pytest.raises(ValueError, match="grad_accum"):
        loss_and_grads(config, params, tokens[:3], grad_accum=2)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_runs_the_flash_forward_again_in_the_backward(remat, monkeypatch):
    """One flash forward per layer without remat; with remat the backward
    recomputes each block, so the forward runs twice per layer (on the
    card: twice the forward kernel's launches)."""
    from ray_tpu_torch.ops import attention

    calls = []
    real = attention._flash_fwd
    monkeypatch.setattr(attention, "_flash_fwd", lambda *a: calls.append(1) or real(*a))
    config = tmodels.get_config("llama-tiny").replace(remat=remat)
    params = {k: ({kk: vv.requires_grad_() for kk, vv in v.items()} if k == "blocks"
                  else v.requires_grad_())
              for k, v in tmodels.init_params(config, 0, device="cpu").items()}
    tokens = _t(np.random.default_rng(6).integers(0, config.vocab_size, (2, 9)))
    loss_and_grads(config, params, tokens, loss_chunk=0)
    assert len(calls) == config.n_layers * (2 if remat else 1)


def test_train_step_state_updates_in_place_and_reduces_loss():
    """Overfitting one batch: the loss falls below 0.7x its first value (the
    JAX test's bar), the state object is advanced in place and the metrics
    stay tensors."""
    config = tmodels.get_config("gpt2-tiny")
    opt = default_optimizer(1e-2, warmup_steps=2, total_steps=40)
    state = create_train_state(config, opt, 0, device="cpu")
    step = make_train_step(config, opt, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, config.vocab_size, (8, 33)))
    wte = state.params["wte"]
    losses = []
    for _ in range(30):
        new_state, metrics = step(state, {"tokens": tokens})
        assert new_state is state and isinstance(metrics["loss"], torch.Tensor)
        losses.append(float(metrics["loss"]))
    assert state.params["wte"] is wte and wte.requires_grad
    assert state.step == 30 and state.opt_state.count == 30
    assert losses[-1] < 0.7 * losses[0], losses[:3] + losses[-3:]


def test_count_params_and_config_fields():
    config = tmodels.get_config("llama-tiny")
    jparams = jmodels.init_params(jmodels.get_config("llama-tiny"), jax.random.PRNGKey(0))
    tparams = tmodels.init_params(config, 0, device="cpu")
    assert tmodels.count_params(tparams) == jmodels.count_params(jparams)
    assert tmodels.get_config("llama3-8b").remat and not tmodels.get_config("gpt2-small").remat
    assert (config.attn_impl, config.causal) == (None, True)
