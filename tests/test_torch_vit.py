"""ViT and CLIP of ray_tpu_torch (`models/vit.py`) against the JAX package
on the CPU.

The port's towers run through `transformer._block` with the plain flash
path on CPU tensors (`causal=False` for the image encoder, causal for
CLIP's text tower), from JAX's `vit_tiny` / `clip_tiny` initial
parameters carried with `params_from_numpy` (nested for CLIP); images,
tokens and lengths are numpy from seeds.

Tolerances (f32): `patchify` bitwise (a reshape); outputs and losses at
atol = rtol = 1e-5; gradients and the parameters after 3 SGD steps on
`clip_loss` at 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import vit
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.util.tree import flatten

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
CLIP_STEPS, CLIP_LR = 3, 0.5


def _images(b=4, size=32, seed=2):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _text(b=4, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 16)).astype(np.int32),
            rng.integers(3, 17, (b,)).astype(np.int32))


def _convert(tree):
    return params_from_numpy(tree, vit.vit_tiny().encoder_config, device="cpu",
                             dtype=torch.float32)


def _jax_vit(pool="cls", remat=False):
    import jax

    from ray_tpu.models import vit as jvit

    config = jvit.vit_tiny().replace(pool=pool, remat=remat)
    params = jvit.init_params(config, jax.random.PRNGKey(0))
    return config, params, jax.tree.map(np.asarray, params)


# JAX's TransformerConfig fields the port has no counterpart for
# (`models/transformer.py`'s docstring), and the dtypes (another type)
_SKIP = ("dtype", "param_dtype", "fused_qkv", "scan_unroll")


def _fields(config):
    out = {}
    for f in dataclasses.fields(config):
        value = getattr(config, f.name)
        if dataclasses.is_dataclass(value):
            out[f.name] = _fields(value)
        elif f.name not in _SKIP:
            out[f.name] = value
    return out


def test_configs_match_jax():
    from ray_tpu.models import vit as jvit

    for name in ("vit_b16", "vit_l16", "vit_tiny"):
        mine, ref = getattr(vit, name)(), getattr(jvit, name)()
        assert _fields(mine) == _fields(ref), name
        assert mine.num_patches == ref.num_patches
        enc, jenc = mine.encoder_config, ref.encoder_config
        assert _fields(enc) == _fields(jenc)
        assert enc.causal is False
    assert _fields(vit.clip_tiny()) == _fields(jvit.clip_tiny())
    assert _fields(vit.CLIPConfig()) == _fields(jvit.CLIPConfig())


def test_patchify_is_jax_s_bitwise():
    import jax.numpy as jnp

    from ray_tpu.models import vit as jvit

    images = _images(b=3, size=48)
    for patch in (8, 16):
        got = vit.patchify(torch.from_numpy(images), patch).numpy()
        assert np.array_equal(got, np.asarray(jvit.patchify(jnp.asarray(images), patch)))


def test_param_and_axes_trees_match_jax():
    import jax

    from ray_tpu.models import vit as jvit

    config, _, np_params = _jax_vit()
    mine = vit.init_params(vit.vit_tiny(), 0, device="cpu")
    assert {p: tuple(t.shape) for p, t in flatten(mine)} == \
        {p: tuple(v.shape) for p, v in flatten(np_params)}
    flat = jax.tree_util.tree_flatten_with_path(jvit.logical_axes(config),
                                                is_leaf=lambda x: isinstance(x, tuple))[0]
    want = {"/".join(str(k.key) for k in path): tuple(leaf) for path, leaf in flat}
    got = {}
    for key, value in vit.logical_axes(vit.vit_tiny()).items():
        if isinstance(value, dict):
            got.update({f"{key}/{k}": tuple(v) for k, v in value.items()})
        else:
            got[key] = tuple(value)
    assert got == want
    clip = vit.init_clip_params(vit.clip_tiny(), 0, device="cpu")
    jclip = jvit.init_clip_params(jvit.clip_tiny(), jax.random.PRNGKey(0))
    assert {p: tuple(t.shape) for p, t in flatten(clip)} == \
        {p: tuple(np.shape(v)) for p, v in flatten(jax.tree.map(np.asarray, jclip))}


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_forward_matches_jax(pool):
    import jax.numpy as jnp

    from ray_tpu.models import vit as jvit

    config, params, np_params = _jax_vit(pool)
    images = _images()
    want = np.asarray(jvit.forward(params, jnp.asarray(images), config))
    with torch.no_grad():
        got = vit.forward(_convert(np_params), torch.from_numpy(images),
                          vit.vit_tiny().replace(pool=pool))
    assert got.shape == (4, config.out_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_vit_gradients_match_jax(remat):
    """The gradient of a fixed linear function of the logits; the encoder
    is non-causal (its attention is the flash path's `causal=False`)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import vit as jvit

    config, params, np_params = _jax_vit(remat=remat)
    images = _images()
    probe = np.random.default_rng(4).standard_normal((4, config.out_dim)).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jvit.forward(p, jnp.asarray(images), config) * probe))(
        params)
    mine = _convert(np_params)
    paths, leaves = zip(*flatten(mine))
    for t in leaves:
        t.requires_grad_()
    out = vit.forward(mine, torch.from_numpy(images), vit.vit_tiny().replace(remat=remat))
    got = torch.autograd.grad((out * torch.from_numpy(probe)).sum(), leaves)
    want = dict(flatten(jax.tree.map(np.asarray, grads)))
    for path, g in zip(paths, got):
        np.testing.assert_allclose(g.numpy(), want[path], err_msg=path, **GRAD_TOL)


def _jax_clip():
    import jax

    from ray_tpu.models import vit as jvit

    config = jvit.clip_tiny()
    params = jvit.init_clip_params(config, jax.random.PRNGKey(1))
    return config, params, jax.tree.map(np.asarray, params)


def test_clip_forward_matches_jax():
    import jax.numpy as jnp

    from ray_tpu.models import vit as jvit

    config, params, np_params = _jax_clip()
    images = _images()
    tokens, lengths = _text()
    want = jvit.clip_forward(params, jnp.asarray(images), jnp.asarray(tokens),
                             jnp.asarray(lengths), config)
    with torch.no_grad():
        got = vit.clip_forward(_convert(np_params), torch.from_numpy(images),
                               torch.from_numpy(tokens), torch.from_numpy(lengths),
                               vit.clip_tiny())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # L2-normalised embeddings
    np.testing.assert_allclose(np.linalg.norm(got[0].numpy(), axis=-1), 1.0, atol=1e-5)


def test_clip_loss_over_sgd_steps_matches_jax():
    """CLIP_STEPS steps of plain SGD on `clip_loss`, taken apart in each
    package from the same parameters and batch: each step's loss and the
    parameters after the last."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import vit as jvit

    config, params, np_params = _jax_clip()
    images = _images()
    tokens, lengths = _text()
    batch = (jnp.asarray(images), jnp.asarray(tokens), jnp.asarray(lengths))
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jvit.clip_loss(p, *batch, config)))
    want_losses = []
    for _ in range(CLIP_STEPS):
        loss, grads = value_and_grad(params)
        want_losses.append(float(loss))
        params = jax.tree.map(lambda p, g: p - CLIP_LR * g, params, grads)
    mine = _convert(np_params)
    paths, leaves = zip(*flatten(mine))
    for t in leaves:
        t.requires_grad_()
    tbatch = (torch.from_numpy(images), torch.from_numpy(tokens), torch.from_numpy(lengths))
    losses = []
    for _ in range(CLIP_STEPS):
        loss = vit.clip_loss(mine, *tbatch, vit.clip_tiny())
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.item())
        with torch.no_grad():
            torch._foreach_add_(list(leaves), list(grads), alpha=-CLIP_LR)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert losses[-1] < losses[0]
    want = dict(flatten(jax.tree.map(np.asarray, params)))
    for path, t in zip(paths, leaves):
        np.testing.assert_allclose(t.detach().numpy(), want[path], err_msg=path, **GRAD_TOL)
