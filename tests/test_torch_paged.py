"""ray_tpu_torch.serve.llm against ray_tpu.serve.llm on the CPU.

The device passes (`ragged_mixed_step`, `paged_decode_step`,
`batched_chunk_prefill_step`) are compared with the JAX passes on the same
converted weights and the same random page pool: logits at atol = rtol =
1e-4 (f32 sums in another order through four layers) and the updated pool
at the same tolerance, scratch page 0 excepted (pad rows and inactive
lanes dump there, in an order neither side defines). The engine is
compared token for token with the JAX engine under greedy decoding.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jmodels
from ray_tpu.serve.llm import paged as jpaged
from ray_tpu.serve.llm.paged_engine import PagedEngineConfig as JEngineConfig
from ray_tpu.serve.llm.paged_engine import PagedLLMEngine as JEngine
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.serve.llm import paged as tpaged
from ray_tpu_torch.serve.llm.paged_engine import PagedEngineConfig, PagedLLMEngine
from ray_tpu_torch.serve.llm.server import LLMServer
from ray_tpu_torch.serve.llm.speculative import filtered_scores

TOL = dict(atol=1e-4, rtol=1e-4)
PC = dict(page_size=8, num_pages=32, max_pages_per_slot=8, chunk_pages=2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _converted(name, seed=0):
    jconfig = jmodels.get_config(name)
    jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(seed))
    tconfig = tmodels.get_config(name)
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams), tconfig, device="cpu")
    return jconfig, jparams, tconfig, tparams


def _jax_pass(fn, params, pool, host, config, **static):
    """Run a JAX device pass under jit (one compile instead of op-by-op
    dispatch) on numpy inputs."""
    jitted = jax.jit(functools.partial(fn, config=config, **static))
    return jitted(params, {k: jnp.asarray(v) for k, v in pool.items()},
                  *[jnp.asarray(a) for a in host])


def _random_pool(config, num_pages, page_size, seed):
    rng = np.random.default_rng(seed)
    shape = (config.kv_heads, config.n_layers * num_pages, page_size, config.head_dim)
    return {
        "k": rng.standard_normal(shape).astype(np.float32),
        "v": rng.standard_normal(shape).astype(np.float32),
    }


def _assert_pool_close(jcache, tcache, n_layers, num_pages):
    keep = np.ones(n_layers * num_pages, bool)
    keep[np.arange(n_layers) * num_pages] = False  # every layer's scratch page
    for name in ("k", "v"):
        np.testing.assert_allclose(
            np.asarray(jcache[name])[:, keep], tcache[name].numpy()[:, keep], **TOL
        )


# ------------------------------------------------------------ device passes


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
@pytest.mark.parametrize("dec_width", [1, 3], ids=["decode", "verify"])
def test_ragged_mixed_step_matches_jax(name, dec_width):
    """Prefill lanes: one continuing at offset 16 (its first two pages are
    already in the pool), one fresh full chunk, one inactive. Decode lanes:
    active, inactive, and (verify) a shorter region than the tick's width."""
    jconfig, jparams, tconfig, tparams = _converted(name)
    ps, num_pages, maxp, cp = PC["page_size"], PC["num_pages"], PC["max_pages_per_slot"], PC["chunk_pages"]
    chunk = ps * cp
    rng = np.random.default_rng(5)
    pool = _random_pool(jconfig, num_pages, ps, seed=6)
    page_rows = np.zeros((3 + 3, maxp), np.int32)
    page_rows[0, :4] = [1, 2, 3, 4]        # prefill lane 0: pages 1-2 hold its prompt so far
    page_rows[1, :2] = [5, 6]              # prefill lane 1: fresh
    page_rows[3, :3] = [7, 8, 9]           # decode lane 0: position 20
    page_rows[5, :2] = [10, 11]            # decode lane 2: position 7
    chunk_ids = np.array([[3, 4], [5, 6], [0, 0]], np.int32)
    tokens = rng.integers(1, jconfig.vocab_size, (3, chunk)).astype(np.int32)
    tokens[0, 10:] = 0
    offsets = np.array([16, 0, 0], np.int32)
    totals = np.array([26, 16, 0], np.int32)
    dec_tokens = rng.integers(1, jconfig.vocab_size, (3, dec_width)).astype(np.int32)
    dec_positions = np.array([20, 0, 7], np.int32)
    dec_active = np.array([dec_width, 0, max(1, dec_width - 1)], np.int32)
    if dec_width == 1:
        dec_tokens = dec_tokens[:, 0]
    host = (page_rows, chunk_ids, tokens, offsets, totals, dec_tokens, dec_positions, dec_active)
    jlog, jdec, jcache = _jax_pass(jpaged.ragged_mixed_step, jparams, pool, host, jconfig,
                                   page_size=ps)
    tlog, tdec, tcache = tpaged.ragged_mixed_step(
        tparams, {k: _t(v) for k, v in pool.items()}, *[_t(a) for a in host], tconfig,
        page_size=ps,
    )
    np.testing.assert_allclose(np.asarray(jlog)[:2], tlog.numpy()[:2], **TOL)
    active = dec_active > 0
    if dec_width == 1:
        np.testing.assert_allclose(np.asarray(jdec)[active], tdec.numpy()[active], **TOL)
    else:
        for lane in np.flatnonzero(active):
            n = int(dec_active[lane])
            np.testing.assert_allclose(np.asarray(jdec)[lane, :n], tdec.numpy()[lane, :n], **TOL)
    _assert_pool_close(jcache, tcache, jconfig.n_layers, num_pages)


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_paged_decode_step_matches_jax(name):
    jconfig, jparams, tconfig, tparams = _converted(name, seed=2)
    ps, num_pages, maxp = PC["page_size"], PC["num_pages"], PC["max_pages_per_slot"]
    pool = _random_pool(jconfig, num_pages, ps, seed=7)
    tables = np.zeros((3, maxp), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :1] = [4]
    tables[2, :5] = [5, 6, 7, 8, 9]
    tokens = np.array([11, 22, 33], np.int32)
    positions = np.array([17, 0, 39], np.int32)
    jlog, jcache = _jax_pass(jpaged.paged_decode_step, jparams, pool,
                             (tables, tokens, positions), jconfig, page_size=ps)
    tlog, tcache = tpaged.paged_decode_step(
        tparams, {k: _t(v) for k, v in pool.items()}, _t(tables), _t(tokens),
        _t(positions), tconfig, page_size=ps,
    )
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    _assert_pool_close(jcache, tcache, jconfig.n_layers, num_pages)


def test_batched_chunk_prefill_step_matches_jax():
    jconfig, jparams, tconfig, tparams = _converted("llama-tiny", seed=3)
    ps, num_pages, maxp = PC["page_size"], PC["num_pages"], PC["max_pages_per_slot"]
    pool = _random_pool(jconfig, num_pages, ps, seed=8)
    rows = np.zeros((2, maxp), np.int32)
    rows[0, :4] = [1, 2, 3, 4]
    rows[1, :2] = [5, 6]
    chunk_ids = np.array([[3, 4], [5, 6]], np.int32)
    tokens = np.random.default_rng(9).integers(1, 200, (2, 16)).astype(np.int32)
    offsets = np.array([16, 0], np.int32)
    totals = np.array([29, 16], np.int32)
    host = (rows, chunk_ids, tokens, offsets, totals)
    jlog, jcache = _jax_pass(jpaged.batched_chunk_prefill_step, jparams, pool, host,
                             jconfig, page_size=ps)
    tlog, tcache = tpaged.batched_chunk_prefill_step(
        tparams, {k: _t(v) for k, v in pool.items()}, *[_t(a) for a in host], tconfig,
        page_size=ps,
    )
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    _assert_pool_close(jcache, tcache, jconfig.n_layers, num_pages)


def test_allocator_exhaustion_and_reuse():
    a = tpaged.PageAllocator(num_pages=5)  # 4 allocatable (page 0 reserved)
    p = a.alloc(4)
    assert sorted(p) == [1, 2, 3, 4]
    assert a.alloc(1) is None
    a.free(p[:2])
    a.free(p[:2])  # a double free is ignored
    assert a.available == 2
    assert set(a.alloc(2)) <= {1, 2, 3, 4}


def test_filtered_scores_match_jax():
    from ray_tpu.serve.llm.speculative import filtered_scores as jfiltered

    rng = np.random.default_rng(10)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    temps = np.array([0.7, 1.0, 1.3, 0.5], np.float32)
    top_ks = np.array([0, 5, 1, 20], np.int32)
    top_ps = np.array([0.9, 1.0, 1.0, 0.5], np.float32)
    ref = np.asarray(jfiltered(*[jnp.asarray(a) for a in (logits, temps, top_ks, top_ps)]))
    out = filtered_scores(*[_t(a) for a in (logits, temps, top_ks, top_ps)]).numpy()
    np.testing.assert_array_equal(np.isfinite(ref), np.isfinite(out))
    np.testing.assert_allclose(ref[np.isfinite(ref)], out[np.isfinite(out)], atol=1e-6)


# ------------------------------------------------------------------ engine

ENGINE_PC = dict(page_size=8, num_pages=64, max_pages_per_slot=8, chunk_pages=2)
MULTI_CHUNK = [int(t) for t in np.random.default_rng(3).integers(1, 200, size=41)]
STAGGERED = [[1, 2, 3], [9, 8], [30, 31, 32, 33], [4], [100, 101]]


def _drive(engine, max_tokens=6):
    """A multi-chunk prompt, then staggered short requests (more requests
    than slots, so some queue for admission)."""
    streams = [engine.submit(MULTI_CHUNK, max_tokens=max_tokens)]
    for prompt in STAGGERED:
        time.sleep(0.02)
        streams.append(engine.submit(prompt, max_tokens=max_tokens))
    return [s.result(timeout=120) for s in streams]


@pytest.fixture(scope="module")
def llama_tiny_weights():
    return _converted("llama-tiny", seed=0)


@pytest.fixture(scope="module")
def jax_engine_tokens(llama_tiny_weights):
    jconfig, jparams, _, _ = llama_tiny_weights
    engine = JEngine(
        jconfig, jparams,
        JEngineConfig(max_slots=4, paged=jpaged.PagedConfig(**ENGINE_PC)),
    )
    try:
        return _drive(engine)
    finally:
        engine.shutdown()


def test_engine_greedy_tokens_match_jax_engine(llama_tiny_weights, jax_engine_tokens):
    _, _, tconfig, tparams = llama_tiny_weights
    engine = PagedLLMEngine(
        tconfig, tparams,
        PagedEngineConfig(max_slots=4, paged=tpaged.PagedConfig(**ENGINE_PC)),
        device="cpu",
    )
    try:
        got = _drive(engine)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert got == jax_engine_tokens
    assert stats["prefill_chunks"] >= 3 + len(STAGGERED)  # 41 tokens = 3 chunks
    assert stats["mixed_ticks"] > 0 and stats["decode_blocks"] > 0
    assert stats["pages_free"] == ENGINE_PC["num_pages"] - 1  # every page returned


@pytest.mark.parametrize("max_inflight_blocks", [1, 8])
def test_pipelined_engine_tokens_match_jax_engine(llama_tiny_weights, jax_engine_tokens,
                                                  monkeypatch, max_inflight_blocks):
    """The pipelined dispatch at one block in flight and at eight, with a
    slowed drain (each device read sleeps 20 ms first) so dispatch runs
    ahead of emission: the JAX engine's greedy tokens, every page back."""
    from ray_tpu_torch.serve.llm import paged_engine

    read = paged_engine._Fetch.values

    def slow(fetch):
        time.sleep(0.02)
        return read(fetch)

    monkeypatch.setattr(paged_engine._Fetch, "values", slow)
    _, _, tconfig, tparams = llama_tiny_weights
    engine = PagedLLMEngine(
        tconfig, tparams,
        PagedEngineConfig(max_slots=4, max_inflight_blocks=max_inflight_blocks,
                          paged=tpaged.PagedConfig(**ENGINE_PC)),
        device="cpu",
    )
    try:
        got = _drive(engine)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert got == jax_engine_tokens
    assert stats["pages_free"] == ENGINE_PC["num_pages"] - 1 and stats["inflight_blocks"] == 0


def test_server_generate_matches_jax_engine(llama_tiny_weights, jax_engine_tokens):
    _, _, tconfig, tparams = llama_tiny_weights
    server = LLMServer(
        tconfig, tparams,
        PagedEngineConfig(max_slots=2, decode_block_steps=4,
                          paged=tpaged.PagedConfig(**ENGINE_PC)),
        device="cpu",
    )
    try:
        out = server.generate({"prompt_tokens": MULTI_CHUNK, "max_tokens": 6})
        assert out["tokens"] == jax_engine_tokens[0]
        assert out["usage"] == {"prompt_tokens": 41, "completion_tokens": 6, "total_tokens": 47}
        assert out["ttft_s"] is not None and out["ttft_s"] > 0
        streamed = list(server.stream_generate({"prompt_tokens": STAGGERED[2], "max_tokens": 6}))
        assert [m["token"] for m in streamed[:-1]] == jax_engine_tokens[3]
        assert streamed[-1]["done"] and streamed[-1]["usage"]["completion_tokens"] == 6
    finally:
        server.shutdown()


# deterministic for requests served one after another: no timing in them
SERVER_METRIC_KEYS = ("generated_tokens", "decode_tokens", "prefill_tokens", "prefill_chunks",
                      "page_stalls", "prefix_cache_hits", "prefix_cache_misses",
                      "prefix_cache_cow", "spec_proposed", "spec_accepted",
                      "spec_rollback_pages")


def test_server_metrics_health_and_request_id_match_jax(llama_tiny_weights):
    """metrics(), check_health() and the replies' request_id against JAX's
    LLMServer on the same weights: the same tokens and ids (taken from the
    payload), the same counts in metrics() for the same requests, and
    check_health() passing while the loop runs and raising once it has
    stopped."""
    from ray_tpu.serve.llm.server import LLMServer as JServer

    jconfig, jparams, tconfig, tparams = llama_tiny_weights
    servers = [
        JServer(jconfig, jparams, JEngineConfig(max_slots=2, paged=jpaged.PagedConfig(**ENGINE_PC))),
        LLMServer(tconfig, tparams, PagedEngineConfig(
            max_slots=2, paged=tpaged.PagedConfig(**ENGINE_PC)), device="cpu"),
    ]
    seen = []
    try:
        for server in servers:
            server.check_health()
            out = server.generate({"prompt_tokens": MULTI_CHUNK, "max_tokens": 5,
                                   "request_id": "req-7"})
            streamed = list(server.stream_generate({"prompt_tokens": STAGGERED[2],
                                                    "max_tokens": 4, "request_id": 42}))
            metrics = server.metrics()
            seen.append((out["tokens"], out["request_id"], [m["token"] for m in streamed[:-1]],
                         streamed[-1]["request_id"], {k: metrics[k] for k in SERVER_METRIC_KEYS}))
            server.check_health()
        anonymous = [server.generate({"prompt_tokens": [1, 2, 3], "max_tokens": 2})
                     for server in servers]
    finally:
        for server in servers:
            server.engine.shutdown()
    assert seen[0] == seen[1]
    assert seen[1][1] == "req-7" and seen[1][3] == "42" and seen[1][4]["generated_tokens"] == 9
    # no id in the payload: the engine mints one, as JAX's does with the
    # request log on (the default)
    assert all(a["request_id"].startswith("req-") for a in anonymous)
    assert set(servers[1].metrics()) <= set(servers[0].metrics())
    for server in servers:
        with pytest.raises(RuntimeError, match="engine loop died"):
            server.check_health()


def test_server_check_health_raises_when_the_loop_dies(llama_tiny_weights, monkeypatch):
    """A device read that fails kills the engine loop; check_health() then
    raises, chained to the failure."""
    from ray_tpu_torch.serve.llm import paged_engine

    def broken(self):
        raise RuntimeError("device read failed")

    monkeypatch.setattr(paged_engine._Fetch, "values", broken)
    _, _, tconfig, tparams = llama_tiny_weights
    server = LLMServer(tconfig, tparams, PagedEngineConfig(
        max_slots=2, paged=tpaged.PagedConfig(**ENGINE_PC)), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="device read failed"):
            server.generate({"prompt_tokens": [1, 2, 3], "max_tokens": 4})
        server.engine._thread.join(timeout=30)
        with pytest.raises(RuntimeError, match="engine loop died") as info:
            server.check_health()
        assert "device read failed" in str(info.value.__cause__)
    finally:
        server.shutdown()


def test_engine_stop_conditions_and_sampling(llama_tiny_weights, jax_engine_tokens):
    """Stop ids, stop sequences and max_tokens=1 end streams at the right
    token; top-1 sampling at temperature > 0 is greedy; plain temperature
    sampling stays in the vocabulary."""
    _, _, tconfig, tparams = llama_tiny_weights
    expected = jax_engine_tokens[0]
    engine = PagedLLMEngine(
        tconfig, tparams,
        PagedEngineConfig(max_slots=4, paged=tpaged.PagedConfig(**ENGINE_PC)),
        device="cpu",
    )
    try:
        stop_id = engine.submit(MULTI_CHUNK, max_tokens=6, stop_token_ids=[expected[2]])
        stop_seq = engine.submit(MULTI_CHUNK, max_tokens=6, stop_sequences=[expected[1:3]])
        one = engine.submit(MULTI_CHUNK, max_tokens=1)
        top1 = engine.submit(MULTI_CHUNK, max_tokens=6, temperature=0.8, top_k=1)
        hot = engine.submit(MULTI_CHUNK, max_tokens=6, temperature=1.0)
        assert stop_id.result(timeout=120) == expected[:3]
        assert stop_seq.result(timeout=120) == expected[:3]
        assert one.result(timeout=120) == expected[:1]
        assert top1.result(timeout=120) == expected
        sampled = hot.result(timeout=120)
        assert len(sampled) == 6 and all(0 <= t < tconfig.vocab_size for t in sampled)
    finally:
        engine.shutdown()


def test_engine_page_backpressure_all_requests_complete(llama_tiny_weights):
    """More concurrent demand than pages: admissions wait on the allocator
    and every request finishes with the dense forward's greedy tokens."""
    _, _, tconfig, tparams = llama_tiny_weights
    engine = PagedLLMEngine(
        tconfig, tparams,
        PagedEngineConfig(max_slots=4, paged=tpaged.PagedConfig(
            page_size=8, num_pages=7, max_pages_per_slot=4, chunk_pages=1)),
        device="cpu",
    )
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, 200, size=5)] for _ in range(6)]
    try:
        streams = [engine.submit(p, max_tokens=6) for p in prompts]
        outs = [s.result(timeout=120) for s in streams]
        stats = engine.stats()
    finally:
        engine.shutdown()
    for prompt, got in zip(prompts, outs):
        tokens = list(prompt)
        for _ in range(6):
            logits = tmodels.forward(tparams, torch.tensor([tokens]), tconfig)
            tokens.append(int(torch.argmax(logits[0, -1])))
        assert got == tokens[len(prompt):], (prompt, got)
    assert stats["page_stalls"] > 0
    assert stats["pages_free"] == 6


def test_engine_final_block_overshoot_at_slot_capacity(llama_tiny_weights):
    """prompt + max_tokens fills the slot's page capacity exactly, so the
    final K-step block's overshoot steps run past the block table (and, for
    a 32-token max_seq, past the position tables); their gathers clamp as
    the JAX gathers do, and the stream ends with the dense greedy tokens."""
    _, _, tconfig, tparams = llama_tiny_weights
    config = tconfig.replace(max_seq=32)
    engine = PagedLLMEngine(
        config, tparams,
        PagedEngineConfig(max_slots=2, decode_block_steps=16, paged=tpaged.PagedConfig(
            page_size=8, num_pages=16, max_pages_per_slot=4, chunk_pages=2)),
        device="cpu",
    )
    prompt = [int(t) for t in np.random.default_rng(11).integers(1, 200, size=20)]
    try:
        got = engine.generate(prompt, max_tokens=12)
    finally:
        engine.shutdown()
    tokens = list(prompt)
    for _ in range(12):
        logits = tmodels.forward(tparams, torch.tensor([tokens]), config)
        tokens.append(int(torch.argmax(logits[0, -1])))
    assert got == tokens[len(prompt):]
