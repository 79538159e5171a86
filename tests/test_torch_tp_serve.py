"""Tensor-parallel paged serving of ray_tpu_torch against ray_tpu on the CPU.

The port runs a tp mesh as one program over its shards in one process
(`build_mesh(MeshSpec(tp=n), devices=["cpu"] * n)`: the shards share the
CPU); JAX runs its mesh over n of the 8 forced host devices that
tests/conftest.py gives it (`_tp_mesh`), partitioned by GSPMD. Weights are
JAX's init converted to the port and inputs come from numpy seeds, all in
f32 at tiny sizes:

- `serving_shardings` for llama3-8b: every leaf's spec and shard shape
  equal JAX's (shapes only, no weights);
- the kernel entry points under a mesh (the plain version on the CPU):
  bitwise the port's single-device call, within 1e-5 of JAX's reference;
- the passes over tp = 2: logits and pool within 1e-5 of JAX's
  single-device passes (f32 sums split over the shards add in another
  order);
- the engines: greedy tokens equal to JAX's TP engine and its single
  device; speculation, the prefix cache with copy-on-write and a lane
  preemption (driven by hand, loops patched out) equal to tp = 1 and to
  JAX's TP engine, which runs every mode; decode_flops; the errors; the
  server and the deployment.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jmodels
from ray_tpu.ops import ragged_paged_attention as jragged_paged_attention
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.serve.llm import paged as jpaged
from ray_tpu.serve.llm.paged_engine import PagedEngineConfig as JEngineConfig
from ray_tpu.serve.llm.paged_engine import PagedLLMEngine as JEngine
from ray_tpu.serve.llm.paged_engine import serving_shardings as jserving_shardings
from ray_tpu.serve.llm.server import LLMServer as JServer
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models.transformer import logical_axes
from ray_tpu_torch.ops import ragged_paged_attention
from ray_tpu_torch.ops.ragged_paged_attention import head_blocks
from ray_tpu_torch.parallel import (
    MeshSpec,
    ModelSharding,
    build_mesh,
    default_rules,
    override_rules,
)
from ray_tpu_torch.serve.llm import EngineConfig, LLMServer, build_llm_app
from ray_tpu_torch.serve.llm import paged as tpaged
from ray_tpu_torch.serve.llm.paged_engine import (
    PagedEngineConfig,
    PagedLLMEngine,
    place_params,
    serving_shardings,
)
from ray_tpu_torch.train import default_optimizer, make_train_step

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _tp_mesh(n):
    return jbuild_mesh(JMeshSpec(tp=n), devices=jax.devices()[:n])


def _port_mesh(n):
    return build_mesh(MeshSpec(tp=n), devices=["cpu"] * n)


def _converted(jconfig, tconfig, seed=0):
    jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(seed))
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams), tconfig, device="cpu")
    return jparams, tparams


def _tp_test_config(module, dtype, kv_heads):
    """tests/test_paged_engine.py's TP config (8/8 heads), or its GQA twin."""
    return module.TransformerConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=8, n_kv_heads=kv_heads, d_ff=128,
        max_seq=512, pos_emb="rope", norm="rmsnorm", act="swiglu", use_bias=False, dtype=dtype)


@pytest.fixture(scope="module")
def llama():
    jconfig, tconfig = jmodels.get_config("llama-tiny"), tmodels.get_config("llama-tiny")
    return (jconfig, tconfig, *_converted(jconfig, tconfig))


# ------------------------------------------------------------ the layout


@pytest.mark.parametrize("tp", [2, 8])
def test_serving_shardings_match_jax(tp):
    """llama3-8b's serving layout: each leaf's spec (padded to the leaf's
    rank) and shard shape equal JAX's; the pool splits its kv heads and
    the replicated spec is empty."""
    jconfig, tconfig = jmodels.get_config("llama3-8b"), tmodels.get_config("llama3-8b")
    shapes = jax.eval_shape(lambda: jmodels.init_params(jconfig, jax.random.PRNGKey(0)))
    jparam, jcache, jrep = jserving_shardings(jconfig, _tp_mesh(tp))
    tparam, tcache, trep = serving_shardings(tconfig, _port_mesh(tp))
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jparam)[0])
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(leaves) == len(flat_j) == 12
    for path, leaf in leaves:
        keys = [k.key for k in path]
        node = tparam
        for key in keys:
            node = node[key]
        pad = lambda spec: list(spec) + [None] * (len(leaf.shape) - len(spec))  # noqa: E731
        assert pad(node.spec) == pad(flat_j[path].spec), keys
        assert node.local_shape(leaf.shape) == flat_j[path].shard_shape(leaf.shape), keys
    pool = (jconfig.kv_heads, 4 * 256, 64, jconfig.head_dim)
    assert tcache["k"].local_shape(pool) == jcache["k"].shard_shape(pool) == (8 // tp, 1024, 64, 128)
    assert list(tcache["v"].spec) == list(jcache["v"].spec) == ["tp", None, None, None]
    assert list(trep.spec) == list(jrep.spec) == []


def test_serving_shardings_keep_an_indivisible_vocabulary_whole():
    """GPT-2's 50257 rows over tp = 2: JAX's specs split them, and its
    device_put refuses that; the port keeps the vocabulary whole (the
    training callers' override_rules(vocab=None)) and every other leaf's
    spec equals JAX's."""
    jconfig, tconfig = jmodels.get_config("gpt2-small"), tmodels.get_config("gpt2-small")
    jparam, _, _ = jserving_shardings(jconfig, _tp_mesh(2))
    tparam, _, _ = serving_shardings(tconfig, _port_mesh(2))
    assert list(jparam["wte"].spec)[0] == "tp" and list(tparam["wte"].spec)[0] is None
    for name, sh in tparam["blocks"].items():
        assert list(sh.spec) == list(jparam["blocks"][name].spec), name
    with pytest.raises(ValueError, match="divisible"):
        jax.device_put(np.zeros((jconfig.vocab_size, 4), np.float32),
                       jax.sharding.NamedSharding(_tp_mesh(2), jax.sharding.PartitionSpec("tp")))


def test_serving_shardings_refuse_rules_that_leave_a_megatron_group_whole():
    """The passes run each shard's heads and MLP units: rules that keep the
    MLP's hidden units (or the heads) whole over tp raise."""
    config = tmodels.get_config("llama-tiny")
    for name in ("mlp", "kv_heads"):
        with pytest.raises(ValueError, match="unsplit over tp"):
            serving_shardings(config, _port_mesh(2), override_rules(default_rules(), **{name: None}))


def test_place_params_blocks_and_whole_leaves(llama):
    """Each shard's blocks are its heads and hidden units (copies of its
    own); replicated leaves are the caller's tensors, shared."""
    _, tconfig, _, tparams = llama
    shards = place_params(tparams, tconfig, _port_mesh(2))
    blocks = tparams["blocks"]
    for i, shard in enumerate(shards):
        for name, want in (("wq", blocks["wq"][:, :, 2 * i:2 * i + 2]),
                           ("wk", blocks["wk"][:, :, i:i + 1]),
                           ("w_down", blocks["w_down"][:, 64 * i:64 * i + 64])):
            assert torch.equal(shard["blocks"][name], want), name
            assert shard["blocks"][name].is_contiguous()
        assert torch.equal(shard["wte"], tparams["wte"][128 * i:128 * i + 128])
        assert shard["blocks"]["ln1_scale"] is tparams["blocks"]["ln1_scale"]
        assert shard["blocks"]["wq"].data_ptr() != tparams["blocks"]["wq"].data_ptr()


# ------------------------------------------------------ the kernel entry points


def _ragged_inputs(hkv, seed):
    """A mixed batch, GQA 8/hkv, D 16, pages of 8: a 16-row chunk, a 5-row
    chunk, decode lanes, a verify-shaped region and an inactive lane."""
    rng = np.random.default_rng(seed)
    hq, d, ps, maxp = 8, 16, 8, 6
    q_lens, kv_lens, counts = [16, 5, 1, 1, 3, 0], [24, 5, 17, 40, 11, 0], [2, 1, 1, 1, 1, 1]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tables = np.zeros((len(q_lens), maxp), np.int32)
    nxt = 1
    for s, kl in enumerate(kv_lens):
        for j in range(-(-kl // ps)):
            tables[s, j] = nxt
            nxt += 1
    q = rng.standard_normal((hq, sum(counts) * 8, d)).astype(np.float32)
    k = rng.standard_normal((hkv, nxt + 2, ps, d)).astype(np.float32)
    v = rng.standard_normal((hkv, nxt + 2, ps, d)).astype(np.float32)
    desc = [np.asarray(x, np.int32) for x in (starts, counts, q_lens, kv_lens, tables)]
    return q, k, v, desc


@pytest.mark.parametrize("hkv", [4, 8])
@pytest.mark.parametrize("tp", [2, 4])
def test_ragged_attention_under_a_mesh(tp, hkv):
    """ragged_paged_attention(mesh=): each shard's head group through the
    kernel entry point, the outputs concatenated; bitwise the single call,
    and within 1e-5 of JAX's single-device reference (not of JAX's
    shard_map path, which fails its own tests)."""
    q, k, v, desc = _ragged_inputs(hkv, seed=tp + hkv)
    kw = dict(block_q=8, max_q_blocks=2)
    args = [_t(x) for x in (q, k, v, *desc)]
    whole = ragged_paged_attention(*args, **kw)
    sharded = ragged_paged_attention(*args, **kw, mesh=_port_mesh(tp))
    assert torch.equal(sharded, whole)
    ref = jragged_paged_attention(*[jnp.asarray(x) for x in (q, k, v, *desc)], **kw)
    np.testing.assert_allclose(sharded.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hkv", [4, 8])
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_attention_under_a_mesh(tp, hkv):
    """paged_attention(mesh=), the decode form: bitwise the single call,
    within 1e-5 of JAX's `_gather_ref_attention`."""
    rng = np.random.default_rng(30 + tp + hkv)
    b, hq, d, ps, maxp = 4, 8, 16, 8, 5
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((hkv, 24, ps, d)).astype(np.float32)
    v = rng.standard_normal((hkv, 24, ps, d)).astype(np.float32)
    tables = rng.integers(1, 24, (b, maxp)).astype(np.int32)
    lengths = np.array([1, 9, 40, 23], np.int32)
    args = [_t(x) for x in (q, k, v, tables, lengths)]
    whole = tpaged.paged_attention(*args, page_size=ps)
    sharded = tpaged.paged_attention(*args, page_size=ps, mesh=_port_mesh(tp))
    assert torch.equal(sharded, whole)
    ref = jpaged._gather_ref_attention(*[jnp.asarray(x) for x in (q, k, v, tables, lengths)])
    np.testing.assert_allclose(sharded.numpy(), np.asarray(ref), **TOL)


def test_ragged_mesh_rejects_indivisible_heads():
    q, k, v, desc = _ragged_inputs(4, seed=0)
    with pytest.raises(ValueError, match="must divide"):
        ragged_paged_attention(*[_t(x) for x in (q, k, v, *desc)], block_q=8, max_q_blocks=2,
                               mesh=_port_mesh(8))


# ----------------------------------------------------------------- the passes


def _random_pool(config, num_pages, page_size, seed):
    rng = np.random.default_rng(seed)
    shape = (config.kv_heads, config.n_layers * num_pages, page_size, config.head_dim)
    return {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}


def _shard_pool(pool, mesh):
    """The global pool's per-shard pools (copies of each kv-head block)."""
    blocks = {n: head_blocks(_t(x), mesh) for n, x in pool.items()}
    return [{n: blocks[n][i].clone() for n in pool} for i in range(mesh.size)]


def _assert_pools_close(jcache, pools, n_layers, num_pages):
    keep = np.ones(n_layers * num_pages, bool)
    keep[np.arange(n_layers) * num_pages] = False  # every layer's scratch page
    for name in ("k", "v"):
        got = torch.cat([p[name] for p in pools]).numpy()
        np.testing.assert_allclose(np.asarray(jcache[name])[:, keep], got[:, keep], **TOL)


def _jax_pass(fn, params, pool, host, config, **static):
    jitted = jax.jit(lambda p, c, *a: fn(p, c, *a, config, **static))
    return jitted(params, {k: jnp.asarray(v) for k, v in pool.items()},
                  *[jnp.asarray(a) for a in host])


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_ragged_mixed_step_over_tp2_matches_jax(name):
    """A mixed tick over tp = 2 (llama-tiny: GQA 4/2, the vocabulary split;
    gpt2-tiny: learned positions, biases, the tied head split): prefill
    lanes (one continuing, one fresh, one inactive) and verify-shaped
    decode lanes, against JAX's single-device pass."""
    jconfig, tconfig = jmodels.get_config(name), tmodels.get_config(name)
    jparams, tparams = _converted(jconfig, tconfig, seed=4)
    ps, num_pages, maxp = 8, 32, 8
    rng = np.random.default_rng(5)
    pool = _random_pool(jconfig, num_pages, ps, seed=6)
    page_rows = np.zeros((6, maxp), np.int32)
    page_rows[0, :4] = [1, 2, 3, 4]
    page_rows[1, :2] = [5, 6]
    page_rows[3, :3] = [7, 8, 9]
    page_rows[5, :2] = [10, 11]
    chunk_ids = np.array([[3, 4], [5, 6], [0, 0]], np.int32)
    tokens = rng.integers(1, jconfig.vocab_size, (3, 16)).astype(np.int32)
    tokens[0, 10:] = 0
    dec_tokens = rng.integers(1, jconfig.vocab_size, (3, 3)).astype(np.int32)
    host = (page_rows, chunk_ids, tokens, np.array([16, 0, 0], np.int32),
            np.array([26, 16, 0], np.int32), dec_tokens, np.array([20, 0, 7], np.int32),
            np.array([3, 0, 2], np.int32))
    jlog, jdec, jcache = _jax_pass(jpaged.ragged_mixed_step, jparams, pool, host, jconfig,
                                   page_size=ps)
    mesh = _port_mesh(2)
    pools = _shard_pool(pool, mesh)
    tlog, tdec, out = tpaged.ragged_mixed_step(
        place_params(tparams, tconfig, mesh), pools, *[_t(a) for a in host], tconfig,
        page_size=ps, mesh=mesh)
    assert out is pools
    np.testing.assert_allclose(np.asarray(jlog)[:2], tlog.numpy()[:2], **TOL)
    np.testing.assert_allclose(np.asarray(jdec)[0], tdec.numpy()[0], **TOL)
    np.testing.assert_allclose(np.asarray(jdec)[2, :2], tdec.numpy()[2, :2], **TOL)
    _assert_pools_close(jcache, pools, jconfig.n_layers, num_pages)


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_paged_decode_step_over_tp2_matches_jax(name):
    jconfig, tconfig = jmodels.get_config(name), tmodels.get_config(name)
    jparams, tparams = _converted(jconfig, tconfig, seed=2)
    ps, num_pages, maxp = 8, 32, 8
    pool = _random_pool(jconfig, num_pages, ps, seed=7)
    tables = np.zeros((3, maxp), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :1] = [4]
    tables[2, :5] = [5, 6, 7, 8, 9]
    host = (tables, np.array([11, 22, 33], np.int32), np.array([17, 0, 39], np.int32))
    jlog, jcache = _jax_pass(jpaged.paged_decode_step, jparams, pool, host, jconfig, page_size=ps)
    mesh = _port_mesh(2)
    pools = _shard_pool(pool, mesh)
    tlog, _ = tpaged.paged_decode_step(place_params(tparams, tconfig, mesh), pools,
                                       *[_t(a) for a in host], tconfig, page_size=ps, mesh=mesh)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    _assert_pools_close(jcache, pools, jconfig.n_layers, num_pages)


def test_copy_page_copies_every_shard():
    mesh = _port_mesh(2)
    rng = np.random.default_rng(8)
    pools = [{n: _t(rng.standard_normal((1, 2 * 6, 4, 8)).astype(np.float32)) for n in ("k", "v")}
             for _ in range(2)]
    before = [{n: p[n].clone() for n in p} for p in pools]
    tpaged.copy_page(pools, 3, 5, n_layers=2, mesh=mesh)
    for pool, old in zip(pools, before):
        for n in ("k", "v"):
            for layer in (0, 6):
                assert torch.equal(pool[n][:, layer + 5], old[n][:, layer + 3])
            assert torch.equal(pool[n][:, 4], old[n][:, 4])


# ------------------------------------------------------------------ the engines

ENGINE_PC = dict(page_size=16, num_pages=64, max_pages_per_slot=8, chunk_pages=2)
PROMPT = list(range(1, 20))


def _greedy_run(engine):
    """tests/test_paged_engine.py's TP drill: one greedy request, then 6
    concurrent streams of one prompt."""
    got = engine.generate(PROMPT, max_tokens=10, temperature=0.0)
    streams = [engine.submit(list(range(2, 12)), max_tokens=6) for _ in range(6)]
    return got, [s.result(timeout=120) for s in streams]


@pytest.fixture(scope="module")
def tp_weights():
    out = {}
    for kv in (8, 4):
        jconfig = _tp_test_config(jmodels.transformer, jnp.float32, kv)
        tconfig = _tp_test_config(tmodels.transformer, torch.float32, kv)
        out[kv] = (jconfig, tconfig, *_converted(jconfig, tconfig))
    return out


@pytest.fixture(scope="module")
def jax_greedy(tp_weights):
    """JAX's greedy runs by (kv heads, tp), tp 1 its single device; each
    computed once for the module (each JAX engine compiles its passes)."""
    runs = {}

    def run(kv, tp):
        if (kv, tp) not in runs:
            jconfig, _, jparams, _ = tp_weights[kv]
            engine = JEngine(jconfig, jparams, JEngineConfig(
                max_slots=4, decode_block_steps=4, paged=jpaged.PagedConfig(**ENGINE_PC)),
                mesh=_tp_mesh(tp) if tp > 1 else None)
            try:
                runs[kv, tp] = _greedy_run(engine)
            finally:
                engine.shutdown()
        return runs[kv, tp]

    return run


@pytest.mark.parametrize("kv", [8, 4], ids=["mha8", "gqa8-4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_matches_jax_greedy(tp_weights, jax_greedy, tp, kv):
    """The port's tp engine gives JAX's TP engine's greedy tokens and JAX's
    single device's; the 6 concurrent streams agree; every page returns;
    each mixed tick launches the kernel tp times a layer."""
    _, tconfig, _, tparams = tp_weights[kv]
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, decode_block_steps=4, paged=tpaged.PagedConfig(**ENGINE_PC)),
        mesh=_port_mesh(tp))
    try:
        got, outs = _greedy_run(engine)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert engine.device == torch.device("cpu") and len(engine.cache) == tp
    assert engine.cache[0]["k"].shape[0] == kv // tp
    assert (got, outs) == jax_greedy(kv, tp) == jax_greedy(kv, 1)
    assert all(len(o) == 6 for o in outs) and all(o == outs[0] for o in outs)
    assert stats["pages_free"] == ENGINE_PC["num_pages"] - 1


# (e) the modes, under tp = 2 on llama-tiny (GQA 4/2, vocabulary split),
# against tp = 1 and JAX's TP engine (its TP engine runs every mode)

PC = dict(page_size=8, num_pages=64, max_pages_per_slot=8, chunk_pages=2)
REPEAT = [5, 17, 42, 7, 5, 17, 42, 7, 5, 17, 42, 7]
STAGGERED = [[1, 2, 3, 1, 2, 3], [9, 8, 9, 8], list(range(60, 80))]
SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_rollback_pages")
PREFIX_KEYS = ("prefix_cache_hits", "prefix_cache_misses", "prefix_cache_pages",
               "prefix_cache_evictions", "prefix_cache_cow")


def _engines(llama, paged=PC, **kw):
    """[(label, engine)]: JAX's engine on a tp = 2 mesh, then the port's
    at tp = 1 and tp = 2, all with the same engine config."""
    jconfig, tconfig, jparams, tparams = llama
    out = [("jax", JEngine(jconfig, jparams, JEngineConfig(paged=jpaged.PagedConfig(**paged), **kw),
                           mesh=_tp_mesh(2)))]
    for tp in (1, 2):
        mesh = _port_mesh(tp) if tp > 1 else None
        out.append((f"tp{tp}", PagedLLMEngine(
            tconfig, tparams, PagedEngineConfig(paged=tpaged.PagedConfig(**paged), **kw),
            mesh=mesh, device=None if mesh else "cpu")))
    return out


def test_tp_speculation_matches_tp1_and_jax(llama):
    """Speculation (K = 3, the n-gram proposer): a repetitive request's
    tokens and spec counters, then staggered requests, equal at tp = 1,
    tp = 2 and in JAX's TP engine; the verify passes replace the decode
    blocks."""
    seen = {}
    for label, engine in _engines(llama, max_slots=4, speculative_tokens=3):
        try:
            single = engine.generate(REPEAT, max_tokens=16)
            counts = {k: engine.stats()[k] for k in SPEC_COUNTERS}
            streams = []
            for p in STAGGERED:
                streams.append(engine.submit(p, max_tokens=6))
                time.sleep(0.02)
            seen[label] = (single, counts, [s.result(timeout=120) for s in streams])
            stats = engine.stats()
        finally:
            engine.shutdown()
    assert seen["tp2"] == seen["tp1"] == seen["jax"]
    assert seen["tp2"][1]["spec_proposed"] > 0
    assert not any(k.startswith("passes.decode") for k in stats)


def _prompt(seed, n, lo=1, hi=200):
    return [int(t) for t in np.random.default_rng(seed).integers(lo, hi, size=n)]


def test_tp_prefix_cache_matches_tp1_and_jax(llama):
    """The prefix cache: a repeated prompt and a shared-prefix prompt reuse
    cached pages; tokens and the cache's counters equal at tp = 1, tp = 2
    and in JAX's TP engine after every request."""
    prompt = _prompt(5, 20)
    requests = [prompt, prompt, prompt[:16] + _prompt(9, 8)]
    seen = {}
    for label, engine in _engines(llama, max_slots=4, paged=dict(PC, prefix_cache=True)):
        try:
            seen[label] = []
            for p in requests:
                out = engine.generate(p, max_tokens=6)
                stats = engine.stats()
                seen[label].append((out, {k: stats[k] for k in PREFIX_KEYS}))
        finally:
            engine.shutdown()
    assert seen["tp2"] == seen["tp1"] == seen["jax"]
    assert seen["tp2"][-1][1]["prefix_cache_hits"] == 4.0


@pytest.fixture
def manual(monkeypatch):
    """Engines whose loops never run: the test drives admission, ticks,
    dispatch and drains by hand."""
    monkeypatch.setattr(JEngine, "_loop", lambda self: None)
    monkeypatch.setattr(PagedLLMEngine, "_loop", lambda self: None)
    built = []

    def make(llama, **kw):
        pair = _engines(llama, **kw)
        built.extend(e for _, e in pair)
        return pair

    yield make
    for engine in built:
        engine.shutdown()


def _global_pool(engine, name):
    cache = engine.cache
    return np.concatenate([np.asarray(p[name]) for p in cache]) if isinstance(cache, list) \
        else np.asarray(cache[name])


def test_tp_copy_on_write_matches_tp1_and_jax(manual, llama):
    """Copy-on-write by hand: a shared prompt page is copied to a fresh one
    in every shard's pool (each layer's stripe, every kv head), the table
    and refcounts swap as at tp = 1 and in JAX's TP engine."""
    seen = {}
    for label, engine in manual(llama, max_slots=4, paged=dict(PC, prefix_cache=True)):
        engine.submit([5, 17, 42, 7, 3, 11, 9, 2, 8], max_tokens=4)
        engine._admit()
        slot = engine.slots[0]
        while slot.prefilling:
            assert engine._mixed_tick()
        victim = slot.pages[0]
        obs = [victim, engine.allocator.refcount(victim)]
        engine.allocator.share([victim])
        before = {n: _global_pool(engine, n) for n in ("k", "v")}
        assert engine._ensure_private_page(0, slot, 0)
        fresh = slot.pages[0]
        obs += [fresh, int(engine.block_tables[0, 0]), engine.allocator.refcount(victim),
                engine.allocator.refcount(fresh), engine.metrics["prefix_cache_cow"]]
        for n, pool in before.items():
            after = _global_pool(engine, n)
            for i in range(engine.model_config.n_layers):
                stripe = i * engine.paged.num_pages
                np.testing.assert_array_equal(after[:, fresh + stripe], pool[:, victim + stripe])
        engine.allocator.free([victim])
        seen[label] = obs
    assert seen["tp2"] == seen["tp1"] == seen["jax"]
    assert seen["tp2"][1] == 2 and seen["tp2"][4:] == [2, 1, 1.0]


def _drain(engine):
    deadline = time.time() + 30
    while engine._inflight:
        engine._pump_completed(wait=True)
        assert time.time() < deadline, "a fetch never drained"


def _step(engine):
    """One loop iteration by hand: admit, one mixed tick or decode block,
    drain, retire (tests/test_torch_overload.py's `_step`)."""
    engine._admit()
    engine._deadline_sweep()
    if not engine._mixed_tick():
        engine._dispatch_decode_block()
    _drain(engine)
    for i, slot in enumerate(engine.slots):
        if slot.request is not None and not slot.prefilling:
            engine._maybe_retire(i, slot.request)


def _collect(stream, out):
    q = stream._request.out
    while not q.empty():
        item = q.get_nowait()
        if item is None:
            return True
        out.append(item)
    return False


def test_tp_lane_preemption_matches_tp1_and_jax(manual, llama):
    """One slot: a priority-0 lane decodes 5 tokens, a priority-1 submit
    parks it (its tokens folded into its prompt, its pages freed), then it
    resumes by re-prefilling over the shards: both streams and the
    counters equal tp = 1's, JAX's TP engine's and the dense greedy
    reference, but for the parked page count: JAX grows the 20-token
    prompt's second chunk to its whole page window (4 pages), the port
    only to the pages the prompt needs (3), where the 5 decoded positions
    also fit."""
    _, tconfig, _, tparams = llama
    vp, hp = _prompt(4, 20), _prompt(5, 8)
    seen = {}
    for label, engine in manual(llama, max_slots=1, decode_block_steps=2):
        victim = engine.submit(vp, max_tokens=14, tenant="bulk", priority=0)
        vout, hout = [], []
        for _ in range(50):
            _collect(victim, vout)
            if len(vout) >= 5:
                break
            _step(engine)
        high = engine.submit(hp, max_tokens=4, tenant="paid", priority=1)
        engine._admit()
        obs = [engine.metrics["lane_preemptions"], engine.metrics["preempted_pages"],
               len(victim._request.prompt)]
        done = [False, False]
        for _ in range(200):
            done = [d or _collect(s, o) for d, s, o in zip(done, (victim, high), (vout, hout))]
            if all(done):
                break
            _step(engine)
        seen[label] = obs + [vout, hout, engine.metrics["lane_resumes"], engine.allocator.available]
    assert seen["tp2"] == seen["tp1"]
    assert [seen[k].pop(1) for k in ("jax", "tp1")] == [4.0, 3.0]
    assert seen["tp1"] == seen["jax"]

    def greedy(prompt, n):
        tokens = list(prompt)
        for _ in range(n):
            tokens.append(int(torch.argmax(tmodels.forward(tparams, torch.tensor([tokens]),
                                                           tconfig)[0, -1])))
        return tokens[len(prompt):]

    preemptions, pages, _, vout, hout, resumes, free = seen["tp2"]
    assert pages == 3.0
    assert (preemptions, resumes, free) == (1.0, 1.0, PC["num_pages"] - 1)
    assert vout == greedy(vp, 14) and hout == greedy(hp, 4)


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_tp_decode_flops_equal_tp1(name):
    """The decode block's counted FLOPs run every shard: equal to tp = 1's
    (the kernel's flop formula at each shard's heads, the products over
    each shard's columns and rows)."""
    tconfig = tmodels.get_config(name)
    tparams = tmodels.init_params(tconfig, 0, device="cpu")
    flops = {}
    for tp in (1, 2):
        engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
            max_slots=2, decode_block_steps=4, paged=tpaged.PagedConfig(**PC)),
            mesh=_port_mesh(tp) if tp > 1 else None, device=None if tp > 1 else "cpu")
        try:
            engine.generate([1, 2, 3], max_tokens=9)
            flops[tp] = (engine._tick_cost.total_flops, engine.metrics["decode_flops"])
        finally:
            engine.shutdown()
    assert flops[2] == flops[1] and flops[1][0] > 0 and flops[1][1] == flops[1][0]


# ------------------------------------------------------------------ errors


def test_indivisible_heads_raise_must_divide():
    """6 / 3 heads over tp = 4, as tests/test_paged_engine.py: both
    packages refuse the layout with "must divide"."""
    kw = dict(vocab_size=64, d_model=48, n_layers=1, n_heads=6, n_kv_heads=3, d_ff=96,
              max_seq=128, pos_emb="rope", norm="rmsnorm", act="swiglu", use_bias=False)
    jconfig = jmodels.transformer.TransformerConfig(**kw, dtype=jnp.float32)
    tconfig = tmodels.transformer.TransformerConfig(**kw, dtype=torch.float32)
    jparams, tparams = _converted(jconfig, tconfig)
    pc = dict(page_size=8, num_pages=32, max_pages_per_slot=4, chunk_pages=2)
    with pytest.raises(ValueError, match="must divide"):
        JEngine(jconfig, jparams, JEngineConfig(max_slots=2, paged=jpaged.PagedConfig(**pc)),
                mesh=_tp_mesh(4))
    with pytest.raises(ValueError, match="must divide"):
        PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
            max_slots=2, paged=tpaged.PagedConfig(**pc)), mesh=_port_mesh(4))


def test_dense_engine_and_dense_app_refuse_tensor_parallel(llama):
    jconfig, tconfig, jparams, tparams = llama
    with pytest.raises(ValueError, match="requires the paged engine"):
        JServer(jconfig, jparams, None, tensor_parallel=2)
    with pytest.raises(ValueError, match="requires the paged engine"):
        LLMServer(tconfig, tparams, EngineConfig(max_slots=2), tensor_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="requires paged=True"):
        build_llm_app("llama-tiny", tensor_parallel=2, paged=False, device="cpu")


def test_cuda_tensor_parallel_needs_as_many_cards_and_raises_across_cards(llama, monkeypatch):
    """On CUDA the server takes the first n cards: too few is a
    ValueError; n distinct cards raise NotImplementedError from the mesh
    (ROADMAP A4, TP serving across cards). Neither touches a card, so the
    CUDA device count is patched."""
    _, tconfig, _, tparams = llama
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="wants 2 CUDA devices"):
        LLMServer(tconfig, tparams, PagedEngineConfig(max_slots=2), tensor_parallel=2,
                  device="cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="A4 \\(TP serving across cards\\)"):
        LLMServer(tconfig, tparams, PagedEngineConfig(max_slots=2), tensor_parallel=2,
                  device="cuda")
    with pytest.raises(NotImplementedError, match="A4"):
        build_mesh(MeshSpec(tp=2), devices=["cuda:0", "cuda:1"])


def test_single_controller_mesh_rules():
    """A mesh over this process's devices splits tp only, holds every
    device (they may repeat) and is refused by the training step."""
    mesh = _port_mesh(2)
    assert mesh.local and mesh.devices == (torch.device("cpu"),) * 2 and not mesh.groups
    assert [mesh.device_coords(i)["tp"] for i in range(2)] == [0, 1]
    with pytest.raises(ValueError, match="tp only"):
        build_mesh(MeshSpec(dp=2), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="wants 4 devices"):
        build_mesh(MeshSpec(tp=4), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="one rank per process"):
        make_train_step(tmodels.get_config("llama-tiny"), default_optimizer(), mesh=mesh,
                        device="cpu")
    with pytest.raises(ValueError, match="one rank's blocks per process"):
        ModelSharding(mesh, logical_axes(tmodels.get_config("llama-tiny")))


# ---------------------------------------------------------- server and app


def test_llm_server_tensor_parallel_on_cpu(llama):
    """LLMServer(tensor_parallel=2, device="cpu") shards its paged engine
    over 2 CPU shards and answers tp = 1's tokens."""
    _, tconfig, _, tparams = llama
    outs = []
    for tp in (1, 2):
        server = LLMServer(tconfig, tparams, PagedEngineConfig(
            max_slots=2, paged=tpaged.PagedConfig(**PC)), tensor_parallel=tp, device="cpu")
        try:
            outs.append(server.generate({"prompt_tokens": _prompt(3, 30), "max_tokens": 8})["tokens"])
            assert (server.engine.mesh is not None) == (tp > 1)
        finally:
            server.shutdown()
    assert outs[0] == outs[1] and len(outs[0]) == 8


def test_build_llm_app_tensor_parallel_through_serve_run(llama):
    """build_llm_app(tensor_parallel=2, paged=True, device="cpu") deployed
    with serve.run answers, through the handle and streamed, the tokens of
    the tp = 1 deployment of the same weights."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

    _, _, _, tparams = llama
    payload = {"prompt_tokens": _prompt(6, 25), "max_tokens": 6}
    ray_tpu_torch.init(num_cpus=4, detect_accelerators=False)
    try:
        outs = []
        for tp in (1, 2):
            name = f"llm-tp{tp}"
            handle = serve.run(build_llm_app("llama-tiny", name=name, params=tparams, paged=True,
                                             max_slots=2, tensor_parallel=tp, device="cpu"),
                               name=name)
            reply = ray_tpu_torch.get(handle.generate.remote(payload), timeout=120)
            items = [ray_tpu_torch.get(ref, timeout=120)
                     for ref in handle.options(stream=True).stream_generate.remote(payload)]
            outs.append((reply["tokens"], [it["token"] for it in items if "token" in it]))
            serve.delete(name)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert outs[0] == outs[1] and outs[0][0] == outs[0][1] and len(outs[0][0]) == 6
