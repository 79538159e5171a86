"""ray_tpu_torch.models against ray_tpu.models on the CPU.

Weights come from the JAX init (seeded) and are carried over with
`params_from_numpy`, so both sides run the same numbers. Logit tolerance:
atol = rtol = 1e-4 — f32 sums in another order through four layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jmodels
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import params_from_numpy

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _converted(name, seed=0):
    jconfig = jmodels.get_config(name)
    jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(seed))
    tconfig = tmodels.get_config(name)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tconfig, device="cpu")
    return jconfig, jparams, tconfig, tparams


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_forward_logits_match_jax(name):
    jconfig, jparams, tconfig, tparams = _converted(name)
    tokens = np.random.default_rng(0).integers(0, jconfig.vocab_size, (2, 24)).astype(np.int32)
    ref = jax.jit(jmodels.forward, static_argnums=2)(jparams, jnp.asarray(tokens), jconfig)
    out = tmodels.forward(tparams, torch.from_numpy(tokens), tconfig)
    assert out.shape == (2, 24, jconfig.vocab_size)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_forward_hidden_with_positions_matches_jax(name):
    from ray_tpu.models.transformer import forward_hidden as jforward_hidden

    jconfig, jparams, tconfig, tparams = _converted(name, seed=1)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jconfig.vocab_size, (2, 12)).astype(np.int32)
    positions = (np.arange(12)[None, :] + np.array([[0], [30]])).astype(np.int32)
    ref = jax.jit(jforward_hidden, static_argnums=2)(
        jparams, jnp.asarray(tokens), jconfig, positions=jnp.asarray(positions))
    out = tmodels.forward_hidden(
        tparams, torch.from_numpy(tokens), tconfig, positions=torch.from_numpy(positions)
    )
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), **LOGIT_TOL)


def test_presets_match_jax():
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    assert set(tmodels.PRESETS) == set(jmodels.PRESETS)
    for name in jmodels.PRESETS:
        jc, tc = jmodels.get_config(name), tmodels.get_config(name)
        for field in dataclasses.fields(tc):
            jv, tv = getattr(jc, field.name), getattr(tc, field.name)
            if field.name in ("dtype", "param_dtype"):
                jv = dtypes[jv]
            assert jv == tv, (name, field.name, jv, tv)
        assert (jc.head_dim, jc.kv_heads) == (tc.head_dim, tc.kv_heads)
    with pytest.raises(ValueError, match="unknown preset"):
        tmodels.get_config("nope")


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_init_params_tree_matches_jax(name):
    jconfig = jmodels.get_config(name)
    jparams = jax.tree.map(np.asarray, jmodels.init_params(jconfig, jax.random.PRNGKey(0)))
    tconfig = tmodels.get_config(name)
    tparams = tmodels.init_params(tconfig, 0, device="cpu")
    assert tparams.keys() == jparams.keys()
    assert tparams["blocks"].keys() == jparams["blocks"].keys()
    for key, jleaf in jparams["blocks"].items():
        assert tuple(tparams["blocks"][key].shape) == jleaf.shape, key
    for key in jparams:
        if key != "blocks":
            assert tuple(tparams[key].shape) == jparams[key].shape, key
    n_port = sum(t.numel() for t in tparams["blocks"].values()) + sum(
        t.numel() for k, t in tparams.items() if k != "blocks")
    assert n_port == jmodels.count_params(jparams)
    # same distributions: N(0, 0.02) embeddings, 1/sqrt(2L)-scaled out-proj
    wte = tparams["wte"]
    assert wte.dtype == torch.float32
    assert abs(float(wte.std()) - 0.02) < 0.002
    res_std = 0.02 / np.sqrt(2 * tconfig.n_layers)
    assert abs(float(tparams["blocks"]["wo"].std()) - res_std) < 0.2 * res_std
    assert torch.all(tparams["blocks"]["ln1_scale"] == 1)
    # the generator decides the draw: same seed, same weights
    again = tmodels.init_params(tconfig, 0, device="cpu")
    assert torch.equal(again["wte"], wte)


def test_params_from_numpy_dtypes():
    jconfig = jmodels.get_config("gpt2-tiny")
    tree = jax.tree.map(np.asarray, jmodels.init_params(jconfig, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tree, tmodels.get_config("gpt2-tiny"), device="cpu",
                                dtype=torch.bfloat16)
    assert tparams["wte"].dtype == torch.bfloat16
    assert tparams["wpe"].dtype == torch.bfloat16
    assert tparams["blocks"]["wq"].dtype == torch.bfloat16
    assert tparams["blocks"]["ln1_scale"].dtype == torch.float32
    assert tparams["blocks"]["bq"].dtype == torch.float32
    assert tparams["lnf_bias"].dtype == torch.float32
    # the compute-dtype rounding is the one the JAX forward applies
    expect = np.asarray(jnp.asarray(tree["blocks"]["wq"]).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(tparams["blocks"]["wq"].float().numpy(), expect)
