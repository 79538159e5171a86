"""Ring attention, Ulysses and the sp collectives of ray_tpu_torch against
the JAX package on the CPU.

JAX runs on the virtual CPU devices of tests/conftest.py: `MeshSpec(sp=n)`
on the first n. The port runs spawned gloo ranks (`MultihostWorkerGroup`,
120 s timeouts): one gang of 2 (sp = 2) and one of 4 (sp = 4), each one
`build_mesh(MeshSpec(sp=n))`; the gang of 4 also builds dp=2 x ep=2 and
dp=2 x pp=2. Every rank takes the same numpy inputs made from seeds, the
global q / k / v (grouped-query: 4 query heads over 2 kv heads), and
returns its block of each output and, summed over the ranks, the
gradients of the global inputs. The ranks' programs are module-level
(ranks import this module by name, so JAX is imported inside the tests
only).

Tolerances (f32 throughout):
- outputs against JAX's `ring_attention_sharded` /
  `ulysses_attention_sharded`: atol = rtol = 1e-5;
- outputs against `mha_reference`: 1e-4, the multichip dry run's bound
  (`__graft_entry__.py:174`);
- gradients against JAX's: atol = rtol = 1e-4;
- the fused ring body against the plain one: 1e-5;
- the shift and the tiled all-to-all: bitwise (they move values).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.parallel.mesh import Mesh, NamedSharding, PartitionSpec
from ray_tpu_torch.train.multihost import MultihostWorkerGroup

B, HQ, HKV, S, D = 2, 4, 2, 32, 16
TOL = dict(atol=1e-5, rtol=1e-5)
REF_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
SIZES = (2, 4)
CAUSAL = (True, False)
OPS = ("ring", "ulysses")


def _inputs():
    rng = np.random.default_rng(11)
    return dict(
        q=rng.standard_normal((B, HQ, S, D)).astype(np.float32),
        k=rng.standard_normal((B, HKV, S, D)).astype(np.float32),
        v=rng.standard_normal((B, HKV, S, D)).astype(np.float32),
        do=rng.standard_normal((B, HQ, S, D)).astype(np.float32),
        rows=rng.standard_normal((4, 3, 8, 5)).astype(np.float32),
    )


# ------------------------------------------------------------ rank program


def _error(call):
    try:
        call()
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return None


def _sp_rank(config):
    import torch.distributed as dist

    from ray_tpu_torch.ops import ring_attention, ring_attention_sharded, ulysses_attention_sharded
    from ray_tpu_torch.ops.ring_attention import sequence_block
    from ray_tpu_torch.parallel import Wire, all_to_all, build_mesh, shift

    torch.set_num_threads(1)
    n = dist.get_world_size()
    mesh = build_mesh(MeshSpec(sp=n), ["cpu"])
    wire = Wire.for_axis(mesh, "sp")
    q, k, v, do = (torch.from_numpy(config[x]) for x in ("q", "k", "v", "do"))
    out = {"rank": dist.get_rank(), "coords": mesh.coords, "cases": {}}
    fns = {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}
    for causal in CAUSAL:
        case = {}
        for name, fn in fns.items():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, mesh, causal=causal)
            grads = torch.autograd.grad(o, leaves, sequence_block(do, mesh))
            case[name] = o.detach().numpy()
            case[f"{name}_grads"] = [wire.all_reduce(g.clone()).numpy() for g in grads]
        # the fused ring body against the plain one, on this rank's blocks
        rep = HQ // HKV
        blocks = [sequence_block(t, mesh) for t in (q, k.repeat_interleave(rep, 1),
                                                     v.repeat_interleave(rep, 1))]
        for impl in ("fused", "einsum"):
            leaves = [t.clone().requires_grad_() for t in blocks]
            o = ring_attention(*leaves, mesh=mesh, causal=causal, impl=impl)
            grads = torch.autograd.grad(o, leaves, sequence_block(do, mesh))
            case[f"body_{impl}"] = [o.detach().numpy()] + [g.numpy() for g in grads]
        out["cases"][causal] = case
    # the indivisible sequence and heads
    out["errors"] = {
        "ring_seq": _error(lambda: ring_attention_sharded(q[:, :, :S - 1], k[:, :, :S - 1],
                                                          v[:, :, :S - 1], mesh)),
        "ulysses_seq": _error(lambda: ulysses_attention_sharded(q[:, :, :S - 1], k[:, :, :S - 1],
                                                                v[:, :, :S - 1], mesh)),
        "ulysses_heads": _error(lambda: ulysses_attention_sharded(q[:, :3], k[:, :1], v[:, :1],
                                                                  mesh)),
        "ring_impl": _error(lambda: ring_attention(q, k, v, mesh=mesh, impl="pallas")),
    }
    # the shift and the tiled all-to-all with their gradients
    rows = torch.from_numpy(config["rows"][: n])
    mine = rows[wire.rank].clone().requires_grad_()
    weight = torch.arange(mine.numel(), dtype=torch.float32).view(mine.shape)
    shifted = shift(mine, wire)
    (g_shift,) = torch.autograd.grad((shifted * weight).sum(), [mine])
    block = rows[wire.rank, :, :8 // n * n].clone().requires_grad_()
    moved = all_to_all(block, wire, split_dim=1, concat_dim=0)
    (g_moved,) = torch.autograd.grad((moved * torch.arange(moved.numel(), dtype=torch.float32)
                                      .view(moved.shape)).sum(), [block])
    out["collectives"] = dict(shift=shifted.detach().numpy(), shift_back=g_shift.numpy(),
                              a2a=moved.detach().numpy(), a2a_grad=g_moved.numpy(),
                              stats=wire.stats())
    if n == 4:
        # the other axes of A7 lay out over the gang too
        out["meshes"] = {}
        for kw in (dict(dp=2, ep=2), dict(dp=2, pp=2), dict(dp=2, sp=2)):
            m = build_mesh(MeshSpec(**kw), ["cpu"])
            out["meshes"][m.spec.describe()] = dict(
                coords=m.coords, sizes={a: dist.get_world_size(m.group(a))
                                        for a in kw if m.group(a) is not None})
    return out


# --------------------------------------------------------------- fixtures


def _jax_mesh(n):
    import jax

    from ray_tpu.parallel import MeshSpec as JMeshSpec, build_mesh as jbuild_mesh

    return jbuild_mesh(JMeshSpec(sp=n), devices=jax.devices()[:n])


def _jax_case(n, causal, x):
    """JAX's outputs and gradients of sum(out * do) for both ops."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops import ring_attention_sharded, ulysses_attention_sharded

    mesh = _jax_mesh(n)
    q, k, v, do = (jnp.asarray(x[name]) for name in ("q", "k", "v", "do"))
    out = {}
    for name, fn in (("ring", ring_attention_sharded), ("ulysses", ulysses_attention_sharded)):
        def loss(q, k, v, fn=fn):
            o = fn(q, k, v, mesh, causal=causal)
            return jnp.sum(o * do), o

        (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        out[name] = np.asarray(o)
        out[f"{name}_grads"] = [np.asarray(g) for g in grads]
    return out


@pytest.fixture(scope="module")
def runs():
    """Both gangs (2 and 4 spawned gloo ranks) run while JAX computes its
    cases on the virtual CPU devices."""
    import jax.numpy as jnp

    from ray_tpu.ops import mha_reference

    x = _inputs()
    gangs = []
    try:
        for n in SIZES:
            group = MultihostWorkerGroup(n, run_name=f"sp-{n}", backend="gloo", timeout_s=120)
            gangs.append(group)
            group.start()
            gangs[-1] = (group, group.run_async(_sp_rank, x))
        out = {"inputs": x, "jax": {(n, c): _jax_case(n, c, x) for n in SIZES for c in CAUSAL},
               "dense": {c: np.asarray(mha_reference(*(jnp.asarray(x[k]) for k in "qkv"),
                                                     causal=c)) for c in CAUSAL}}
        for n, (group, refs) in zip(SIZES, gangs):
            out[n] = group.finish(refs, timeout=240)
            assert [r["rank"] for r in out[n]] == list(range(n))
    finally:
        for g in gangs:
            (g[0] if isinstance(g, tuple) else g).shutdown()
    return out


def _assemble(n, blocks):
    """The global (B, H, S, D) output from the ranks' sequence blocks."""
    mesh = Mesh(MeshSpec(sp=n), (torch.device("cpu"),))
    return NamedSharding(mesh, PartitionSpec(None, None, "sp", None)).assemble(blocks)


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("op", OPS)
def test_outputs_match_jax_and_reference(runs, op, causal, n):
    got = _assemble(n, [r["cases"][causal][op] for r in runs[n]])
    np.testing.assert_allclose(got, runs["jax"][n, causal][op], **TOL)
    np.testing.assert_allclose(got, runs["dense"][causal], **REF_TOL)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("op", OPS)
def test_gradients_match_jax(runs, op, causal, n):
    want = runs["jax"][n, causal][f"{op}_grads"]
    for r in runs[n]:
        for got, ref in zip(r["cases"][causal][f"{op}_grads"], want):
            np.testing.assert_allclose(got, ref, **GRAD_TOL)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("causal", CAUSAL)
def test_fused_ring_body_matches_plain_body(runs, causal, n):
    for r in runs[n]:
        for fused, plain in zip(r["cases"][causal]["body_fused"], r["cases"][causal]["body_einsum"]):
            np.testing.assert_allclose(fused, plain, **TOL)


@pytest.mark.parametrize("n", SIZES)
def test_indivisible_sequence_and_heads_raise_as_jax_does(runs, n):
    """The port's `_sharded` functions take the global tensors, as JAX's
    `ring_attention` / `ulysses_attention` do, and raise their errors
    (JAX's `_sharded` ones fail earlier, in `device_put`)."""
    import jax.numpy as jnp

    from ray_tpu.ops import ring_attention, ulysses_attention

    x = {k: jnp.asarray(v) for k, v in runs["inputs"].items()}
    mesh = _jax_mesh(n)
    want = {}
    for label, call in (
            ("ring_seq", lambda: ring_attention(
                x["q"][:, :, :S - 1], x["k"][:, :, :S - 1], x["v"][:, :, :S - 1], mesh=mesh)),
            ("ulysses_seq", lambda: ulysses_attention(
                x["q"][:, :, :S - 1], x["k"][:, :, :S - 1], x["v"][:, :, :S - 1], mesh=mesh)),
            ("ulysses_heads", lambda: ulysses_attention(
                x["q"][:, :3], x["k"][:, :1], x["v"][:, :1], mesh=mesh))):
        with pytest.raises(ValueError) as info:
            call()
        want[label] = ("ValueError", str(info.value))
    for r in runs[n]:
        for label, err in want.items():
            assert r["errors"][label] == err, label
        assert r["errors"]["ring_impl"][0] == "ValueError"


@pytest.mark.parametrize("n", SIZES)
def test_shift_and_tiled_all_to_all_match_jax(runs, n):
    """Wire.shift against lax.ppermute to the next rank, the tiled
    all-to-all against lax.all_to_all(tiled=True), both under shard_map on
    JAX's sp mesh, and their gradients (the reverse shift; the all-to-all
    with its dimensions swapped)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from ray_tpu._jax_compat import shard_map

    mesh = _jax_mesh(n)
    rows = jnp.asarray(runs["inputs"]["rows"][:n])
    perm = [(i, (i + 1) % n) for i in range(n)]

    def shifted(x):
        return jax.lax.ppermute(x, "sp", perm)

    def moved(x):
        return jax.lax.all_to_all(x[0], "sp", 1, 0, tiled=True)[None]

    run = shard_map(shifted, mesh=mesh, in_specs=JP("sp"), out_specs=JP("sp"), check_vma=False)
    block = rows[:, :, : 8 // n * n]
    run2 = shard_map(moved, mesh=mesh, in_specs=JP("sp"), out_specs=JP("sp"), check_vma=False)
    want_shift, want_moved = np.asarray(run(rows)), np.asarray(run2(block))
    weight = jnp.arange(rows[0].size, dtype=jnp.float32).reshape(rows.shape[1:])
    back = np.asarray(jax.grad(lambda x: jnp.sum(run(x) * weight[None]))(rows))
    w2 = jnp.arange(want_moved[0].size, dtype=jnp.float32).reshape(want_moved.shape[1:])
    back2 = np.asarray(jax.grad(lambda x: jnp.sum(run2(x) * w2[None]))(block))
    for r in runs[n]:
        got = r["collectives"]
        i = r["rank"]
        assert np.array_equal(got["shift"], want_shift[i])
        assert np.array_equal(got["shift_back"], back[i])
        assert np.array_equal(got["a2a"], want_moved[i])
        assert np.array_equal(got["a2a_grad"], back2[i])
        assert got["stats"]["other"]["bytes"] > 0


def test_mesh_axes_lay_out_over_the_gang(runs):
    """sp, ep and pp build over a torch.distributed job, as dp, fsdp and
    tp do: coordinates row-major over AXIS_ORDER, one group per axis."""
    from ray_tpu_torch.parallel.mesh import coords_of

    for r in runs[2]:
        assert r["coords"]["sp"] == r["rank"]
    for r in runs[4]:
        assert r["coords"]["sp"] == r["rank"]
        for name, m in r["meshes"].items():
            sizes = {axis: int(size) for axis, size in (part.split("=") for part in name.split("x"))}
            spec = MeshSpec(**sizes)
            assert tuple(m["coords"].values()) == coords_of(spec, r["rank"])
            assert all(size == 2 for size in m["sizes"].values()) and len(m["sizes"]) == 2
