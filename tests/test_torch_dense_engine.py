"""ray_tpu_torch's dense engine against ray_tpu's on the CPU.

`decode_step` and its grouped decode attention run on the same numpy
inputs as the JAX functions (f32, tiny configs); `LLMEngine` runs on
weights converted from the JAX init and must emit JAX's `LLMEngine`
greedy tokens, and `LLMServer` builds it when no paged config is given,
as JAX's does. The decode step runs eagerly here (a CUDA graph on the
card: `tests/test_torch_cuda.py`).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jmodels
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve.llm import engine as jengine
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import transformer as ttransformer
from ray_tpu_torch.serve.llm import LLMServer, PagedConfig, PagedEngineConfig, PagedLLMEngine
from ray_tpu_torch.serve.llm import engine as tengine

# f32 on both sides; sums in other orders move the last bits
ATOL = RTOL = 2e-5


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(scope="module")
def converted():
    out = {}
    for name in ("llama-tiny", "gpt2-tiny"):
        jconfig = jmodels.get_config(name)
        jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(0))
        tconfig = tmodels.get_config(name)
        tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams), tconfig,
                                            device="cpu")
        out[name] = (jconfig, jparams, tconfig, tparams)
    return out


# ------------------------------------------------------------- decode step


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2), (8, 1)])
def test_decode_attention_matches_jax(hq, hkv):
    """The grouped view (no repeat of the cache) against JAX's repeat +
    einsum, lengths from 1 to the whole cache."""
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, d = 4, 24, 16
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    lengths = np.array([1, 7, 24, 13], np.int32)
    ref = jtransformer._decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(lengths))
    out = ttransformer._decode_attention(_t(q), _t(k), _t(v), _t(lengths).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_decode_step_matches_jax(converted, name):
    """One step at mixed positions (0, mid, the last cache row) over a
    random cache: the logits, the row each lane writes at its own
    position, and every other row untouched. llama-tiny has GQA 4/2 and
    RoPE at each lane's position; gpt2-tiny learned positions."""
    jconfig, jparams, tconfig, tparams = converted[name]
    rng = np.random.default_rng(1)
    b, s = 5, 32
    shape = (tconfig.n_layers, b, tconfig.kv_heads, s, tconfig.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(0, tconfig.vocab_size, b).astype(np.int32)
    positions = np.array([0, 9, 31, 17, 9], np.int32)
    jlogits, jcache = jtransformer.decode_step(
        jparams, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(tokens),
        jnp.asarray(positions), jconfig)
    tcache = {"k": _t(k), "v": _t(v)}
    tlogits, out_cache = ttransformer.decode_step(tparams, tcache, _t(tokens).long(),
                                                  _t(positions).long(), tconfig)
    assert out_cache is tcache  # in place
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=RTOL)
    for key, orig in (("k", k), ("v", v)):
        got, want = tcache[key].numpy(), np.asarray(jcache[key])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        lanes = np.arange(b)
        written = np.zeros((b, s), bool)
        written[lanes, positions] = True
        untouched = np.broadcast_to(~written[None, :, None, :, None], got.shape)
        np.testing.assert_array_equal(got[untouched], orig[untouched])
        assert not np.allclose(got[:, lanes, :, positions], orig[:, lanes, :, positions])


def test_decode_step_continues_prefill_like_the_dense_forward(converted):
    """prefill then decode_step token by token gives the full forward's
    last-position logits at every step (the cache rows prefill and decode
    write line up)."""
    _, _, tconfig, tparams = converted["llama-tiny"]
    prompt = [int(t) for t in np.random.default_rng(2).integers(1, 200, 11)]
    cache = ttransformer.init_cache(tconfig, 1, 32, device="cpu")
    logits, _ = ttransformer.prefill(tparams, torch.tensor([prompt + [0] * 5]),
                                     torch.tensor([len(prompt)]), cache, tconfig)
    seq = list(prompt)
    for _ in range(6):
        full = tmodels.forward(tparams, torch.tensor([seq]), tconfig)[0, -1]
        np.testing.assert_allclose(logits[0].numpy(), full.numpy(), atol=1e-4, rtol=1e-4)
        seq.append(int(torch.argmax(logits[0])))
        logits, _ = ttransformer.decode_step(tparams, cache, torch.tensor([seq[-1]]),
                                             torch.tensor([len(seq) - 1]), tconfig)


# ------------------------------------------------------------------ engine

STOP_PROMPT = [int(t) for t in np.random.default_rng(7).integers(1, 200, 9)]


def _prompts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(1, 200, n)] for n in (5, 17, 33, 3, 12)]


def _drive(engine):
    """Staggered submits into 2 slots: one request alone until its first
    token, then four more (more requests than slots), then a stop-sequence
    request and a max_tokens=1 request."""
    prompts = _prompts()
    first = engine.submit(prompts[0], max_tokens=7)
    it = iter(first)
    head = [next(it)]
    rest = [engine.submit(p, max_tokens=6) for p in prompts[1:]]
    out = [head + list(it)] + [s.result(timeout=120) for s in rest]
    plain = engine.generate(STOP_PROMPT, 8)
    stop = plain[3:5]
    out.append(engine.submit(STOP_PROMPT, max_tokens=8, stop_sequences=[stop]).result(timeout=120))
    out.append(engine.submit(prompts[2], max_tokens=1).result(timeout=120))
    return out, plain


@pytest.fixture(scope="module")
def jax_dense_tokens(converted):
    jconfig, jparams, _, _ = converted["llama-tiny"]
    engine = jengine.LLMEngine(jconfig, jparams, jengine.EngineConfig(max_slots=2, max_seq=64))
    try:
        return _drive(engine)
    finally:
        engine.shutdown()


def test_engine_greedy_tokens_match_jax(converted, jax_dense_tokens):
    """The same weights, the same requests: JAX's LLMEngine tokens,
    request for request; the stop sequence ends the stream on it, and
    max_tokens=1 gives one token."""
    _, _, tconfig, tparams = converted["llama-tiny"]
    engine = tengine.LLMEngine(tconfig, tparams, tengine.EngineConfig(max_slots=2, max_seq=64),
                               device="cpu")
    try:
        got, plain = _drive(engine)
        stats = engine.stats()
    finally:
        engine.shutdown()
    want, jplain = jax_dense_tokens
    assert got == want and plain == jplain
    assert got[5] == plain[:5] and len(got[6]) == 1
    assert [len(t) for t in got[:5]] == [7, 6, 6, 6, 6]
    assert stats["passes.decode"] == stats["decode_steps"] > 0
    assert stats["prefills"] == 8 and stats["generated_tokens"] == sum(map(len, got)) + 8


def test_engine_matches_the_paged_engine_and_dense_forward(converted):
    """gpt2-tiny (learned positions, MHA): the dense engine's greedy
    tokens equal the paged engine's and the dense forward's argmax chain."""
    _, _, tconfig, tparams = converted["gpt2-tiny"]
    prompt = [int(t) for t in np.random.default_rng(4).integers(1, 200, 21)]
    seq = list(prompt)
    for _ in range(6):
        seq.append(int(torch.argmax(tmodels.forward(tparams, torch.tensor([seq]), tconfig)[0, -1])))
    dense = tengine.LLMEngine(tconfig, tparams, tengine.EngineConfig(max_slots=3), device="cpu")
    paged = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=3, paged=PagedConfig(page_size=8, num_pages=32, max_pages_per_slot=8,
                                       chunk_pages=2)), device="cpu")
    try:
        assert dense.generate(prompt, 6) == paged.generate(prompt, 6) == seq[len(prompt):]
    finally:
        dense.shutdown()
        paged.shutdown()


def test_engine_rejects_what_jax_rejects(converted):
    _, _, tconfig, tparams = converted["llama-tiny"]
    engine = tengine.LLMEngine(tconfig, tparams, tengine.EngineConfig(max_slots=1, max_seq=32),
                               device="cpu")
    try:
        with pytest.raises(ValueError, match="max_seq"):
            engine.submit(list(range(30)), max_tokens=3)
        with pytest.raises(ValueError, match="top_k/top_p"):
            engine.submit([1, 2], max_tokens=2, top_k=5)
    finally:
        engine.shutdown()


def test_engine_death_fails_open_and_later_requests(converted, monkeypatch):
    """A decode step that raises kills the loop: the open stream raises
    the cause, and a later submit raises at once, chained to it."""
    _, _, tconfig, tparams = converted["llama-tiny"]

    def broken(*args, **kwargs):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(tengine, "decode_step", broken)
    engine = tengine.LLMEngine(tconfig, tparams, tengine.EngineConfig(max_slots=1, max_seq=32),
                               device="cpu")
    try:
        stream = engine.submit([1, 2, 3], max_tokens=4)
        with pytest.raises(RuntimeError, match="decode failed"):
            stream.result(timeout=60)
        engine._thread.join(timeout=30)
        assert not engine._thread.is_alive()
        with pytest.raises(RuntimeError, match="engine is dead") as info:
            engine.submit([1, 2], max_tokens=2)
        assert "decode failed" in str(info.value.__cause__)
    finally:
        engine.shutdown()


def test_snapshot_matches_jax(converted, monkeypatch):
    """The lane table and queue depth, loops patched out and admission
    (prefill included) driven by hand: the same rows as JAX's."""
    jconfig, jparams, tconfig, tparams = converted["llama-tiny"]
    monkeypatch.setattr(jengine.LLMEngine, "_loop", lambda self: None)
    monkeypatch.setattr(tengine.LLMEngine, "_loop", lambda self: None)
    engines = [jengine.LLMEngine(jconfig, jparams, jengine.EngineConfig(max_slots=2, max_seq=64)),
               tengine.LLMEngine(tconfig, tparams, tengine.EngineConfig(max_slots=2, max_seq=64),
                                 device="cpu")]
    seen = []
    try:
        for engine in engines:
            obs = [engine.snapshot()]
            engine.submit([5, 6, 7], max_tokens=4, tenant="acme", priority=2, request_id="r-1")
            # explicit ids: JAX's engine draws one when its forensics log is on
            engine.submit([8, 9], max_tokens=3, request_id="r-2")
            engine.submit([1, 2, 3, 4], max_tokens=2, tenant="bulk", request_id="r-3")
            engine._admit()
            obs.append(engine.snapshot())
            seen.append(obs)
    finally:
        for engine in engines:
            engine.shutdown()
    assert seen[0] == seen[1]
    after = seen[1][1]
    assert after["queue_depth"] == 1 and after["kind"] == "dense"
    assert after["lanes"][0] == {"lane": 0, "free": False, "rid": 0, "request_id": "r-1",
                                 "tenant": "acme", "priority": 2, "position": 3, "remaining": 3,
                                 "generated": 1}


# ------------------------------------------------------------------ server


def test_server_builds_the_dense_engine_by_default_like_jax(converted):
    """engine_config=None and EngineConfig() build LLMEngine, as in the
    JAX package (PagedEngineConfig builds the paged engine), and the
    default server's replies equal JAX's default server's on the same
    weights."""
    from ray_tpu.serve.llm.server import LLMServer as JServer

    jconfig, jparams, tconfig, tparams = converted["llama-tiny"]
    prompt = _prompts()[1]
    jserver = JServer(jconfig, jparams, None)
    servers = [LLMServer(tconfig, tparams, None, device="cpu"),
               LLMServer(tconfig, tparams, tengine.EngineConfig(max_slots=3), device="cpu"),
               LLMServer(tconfig, tparams, PagedEngineConfig(
                   max_slots=2, paged=PagedConfig(page_size=8, num_pages=32,
                                                  max_pages_per_slot=8, chunk_pages=2)),
                   device="cpu")]
    try:
        assert isinstance(jserver.engine, jengine.LLMEngine)
        assert [type(s.engine) for s in servers] == [tengine.LLMEngine, tengine.LLMEngine,
                                                     PagedLLMEngine]
        assert servers[1].engine.config.max_slots == 3
        want = jserver.generate({"prompt_tokens": prompt, "max_tokens": 5, "tenant": "t",
                                 "priority": 1, "request_id": "x"})
        for server in servers:
            got = server.generate({"prompt_tokens": prompt, "max_tokens": 5, "tenant": "t",
                                   "priority": 1, "request_id": "x"})
            assert (got["tokens"], got["usage"], got["request_id"]) == (
                want["tokens"], want["usage"], want["request_id"])
            server.check_health()
        streamed = list(servers[0].stream_generate({"prompt_tokens": prompt, "max_tokens": 5}))
        assert [m["token"] for m in streamed[:-1]] == want["tokens"]
        assert set(servers[0].metrics()) <= set(jserver.metrics())
    finally:
        jserver.engine.shutdown()
        for server in servers:
            server.shutdown()
    for server in servers:
        with pytest.raises(RuntimeError, match="engine loop died"):
            server.check_health()


def test_server_reads_context_before_payload(converted):
    """The ambient deadline, tenant, priority and id (serve/context.py)
    win over the payload's fields, as in JAX's `_submit`; an expired
    ambient deadline fails the submit with the typed error."""
    from ray_tpu_torch.core.exceptions import RequestTimeoutError
    from ray_tpu_torch.serve import context

    _, _, tconfig, tparams = converted["llama-tiny"]
    server = LLMServer(tconfig, tparams, tengine.EngineConfig(max_slots=1, max_seq=32),
                       device="cpu")
    seen = {}
    real = server.engine.submit

    def spy(prompt, max_tokens, temperature, **kwargs):
        seen.update(kwargs)
        return real(prompt, max_tokens, temperature, **kwargs)

    server.engine.submit = spy
    tokens = (context._set_request_tenant("ctx-tenant", 3), context._set_request_id("ctx-id"),
              context._set_request_deadline(time.time() + 60))
    try:
        out = server.generate({"prompt_tokens": [1, 2, 3], "max_tokens": 2, "tenant": "p",
                               "priority": 0, "request_id": "p-id"})
        assert out["request_id"] == "ctx-id" and len(out["tokens"]) == 2
        assert (seen["tenant"], seen["priority"]) == ("ctx-tenant", 3)
        assert seen["deadline_ts"] > time.time()
        context._reset_request_deadline(tokens[2])
        expired = context._set_request_deadline(time.time() - 1)
        with pytest.raises(RequestTimeoutError):
            server.generate({"prompt_tokens": [1, 2, 3], "max_tokens": 2})
        context._reset_request_deadline(expired)
    finally:
        context._reset_request_tenant(tokens[0])
        context._reset_request_id(tokens[1])
        server.shutdown()
