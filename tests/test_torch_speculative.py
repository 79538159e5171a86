"""ray_tpu_torch's speculative decoding against ray_tpu's on the CPU.

- The proposers draft the same tokens as JAX's: the n-gram and replay
  proposers on the same contexts, the draft-model proposer on llama-tiny
  weights converted from the JAX init (`params_from_numpy`, f32).
- `init_cache` / `prefill` give JAX's logits and caches within atol = rtol
  = 1e-4 (f32 sums in another order through the layers; the flash path of
  each package runs its plain version here).
- `accept_speculative` is bitwise JAX's at temperature 0; above 0 the
  marginal of the first emitted token is softmax(filtered_scores), by JAX's
  statistical test (total variation under 0.02 over 20000 draws, where the
  sampling noise is about 0.006).
- The spec engine at temperature 0, with the n-gram, replay and
  always-wrong proposers, gives JAX's spec engine's tokens and the port's
  plain engine's; on one request, also JAX's proposed / accepted /
  rolled-back counts. Rollback never frees a prefix-shared page, and a
  round that must write a shared page copies it first (JAX's hand-driven
  cases, on both engines).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jmodels
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve.llm import paged as jpaged
from ray_tpu.serve.llm import speculative as jspec
from ray_tpu.serve.llm.paged_engine import PagedEngineConfig as JEngineConfig
from ray_tpu.serve.llm.paged_engine import PagedLLMEngine as JEngine
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import transformer as ttransformer
from ray_tpu_torch.serve.llm import paged as tpaged
from ray_tpu_torch.serve.llm import speculative as tspec
from ray_tpu_torch.serve.llm.paged_engine import PagedEngineConfig, PagedLLMEngine

TOL = dict(atol=1e-4, rtol=1e-4)
PC = dict(page_size=8, num_pages=64, max_pages_per_slot=8, chunk_pages=2)
SPEC = 3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _converted(name, seed=0):
    jconfig = jmodels.get_config(name)
    jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(seed))
    tconfig = tmodels.get_config(name)
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams), tconfig, device="cpu")
    return jconfig, jparams, tconfig, tparams


@pytest.fixture(scope="module")
def llama():
    return _converted("llama-tiny")


class WrongProposer:
    """Drafts walk a +1 ring the greedy chain almost never follows, so
    nearly every round rejects at its first draft and rolls back."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def propose(self, context, k):
        return [(context[-1] + 1 + i) % self.vocab for i in range(k)]


# ------------------------------------------------------------------ proposers

NGRAM_CONTEXTS = [
    [7, 8, 1, 2, 7, 8, 9, 5, 7, 8],  # the newest occurrence's continuation wins
    [1, 2, 3, 4],                    # novel suffix: no proposal
    [5, 17, 42, 7, 5, 17, 42, 7, 5],
    [3, 3, 3, 3, 3],
    [1],
]


@pytest.mark.parametrize("ctx", NGRAM_CONTEXTS + [
    [int(t) for t in np.random.default_rng(s).integers(0, 6, 30)] for s in range(4)])
@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("ngram", [(3, 1), (2, 2)])
def test_ngram_proposer_matches_jax(ctx, k, ngram):
    mx, mn = ngram
    assert (tspec.NgramProposer(mx, mn).propose(ctx, k)
            == jspec.NgramProposer(mx, mn).propose(ctx, k))


def test_ngram_proposer_rejects_bad_range():
    with pytest.raises(ValueError, match="bad ngram range"):
        tspec.NgramProposer(max_ngram=1, min_ngram=2)


@pytest.mark.parametrize("ctx,k", [
    ([1, 2], 3), ([1, 2, 10, 11], 3), ([1, 2, 10, 99], 3), ([5, 6], 3),
    ([9, 9, 9, 4, 5], 2), ([9, 9, 9], 5), ([1, 2, 10, 11, 12, 13], 4)])
def test_replay_proposer_matches_jax(ctx, k):
    recorded = {(1, 2): [10, 11, 12, 13], (9, 9, 9): [4, 5, 6], (9, 9): [1]}
    assert tspec.ReplayProposer(recorded).propose(ctx, k) == \
        jspec.ReplayProposer(recorded).propose(ctx, k)


def test_replay_proposer_stops_on_divergence():
    p = tspec.ReplayProposer({(1, 2): [10, 11, 12, 13]})
    assert p.propose([1, 2], 3) == [10, 11, 12]
    assert p.propose([1, 2, 10, 11], 3) == [12, 13]
    assert p.propose([1, 2, 10, 99], 3) == []


@pytest.mark.parametrize("context_len,k", [(5, 3), (20, 4), (2, 1)])
def test_draft_model_proposer_matches_jax(llama, context_len, k):
    """Greedy drafts of the same small model (llama-tiny, f32 weights from
    the JAX init) over a 16-token window: the tail that fits, then k
    argmax steps, each a full prefill of the window."""
    jconfig, jparams, tconfig, tparams = llama
    ctx = [int(t) for t in np.random.default_rng(context_len).integers(1, 256, context_len)]
    want = jspec.DraftModelProposer(jconfig, jparams, window=16).propose(ctx, k)
    got = tspec.DraftModelProposer(tconfig, tparams, window=16).propose(ctx, k)
    assert got == want and len(got) == k


# ----------------------------------------------------------- init_cache / prefill


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_prefill_matches_jax(name):
    """Right-padded prompts of two lengths into a cache longer than the
    prompt: last-token logits and the written cache rows (the rest stays
    zero) against JAX's, f32."""
    jconfig, jparams, tconfig, tparams = _converted(name, seed=1)
    tokens = np.random.default_rng(2).integers(1, 200, (2, 12)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)
    tokens[1, 7:] = 0
    jcache = jtransformer.init_cache(jconfig, 2, 20)
    jlog, jnew = jax.jit(jtransformer.prefill, static_argnums=(4,))(
        jparams, jnp.asarray(tokens), jnp.asarray(lengths), jcache, jconfig)
    tcache = ttransformer.init_cache(tconfig, 2, 20, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    tlog, tnew = ttransformer.prefill(tparams, _t(tokens), _t(lengths), tcache, tconfig)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jnew[key]), tnew[key].numpy(), **TOL)
        assert not tnew[key][:, :, :, 12:].any()


def test_init_cache_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttransformer.init_cache(tmodels.get_config("llama-tiny"), 1, 8)


# ---------------------------------------------------------------- accept step


def _accept_both(logits, tokens, counts, temps, top_ks, top_ps, seed=0):
    jout, jn = jspec.accept_speculative(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(counts),
        jax.random.PRNGKey(seed), jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps))
    gen = torch.Generator()
    gen.manual_seed(seed)
    tout, tn = tspec.accept_speculative(
        _t(logits), _t(tokens), _t(counts), gen, _t(temps), _t(top_ks), _t(top_ps))
    return (np.asarray(jout), np.asarray(jn)), (tout.numpy(), tn.numpy())


def test_accept_greedy_exact_prefix_and_bonus():
    """JAX's hand-built case: a lane that accepts 2 drafts then corrects, a
    lane that accepts every draft plus the bonus, an inactive lane."""
    b, kd, v = 3, 4, 11
    logits = np.full((b, kd, v), -10.0, np.float32)
    for j, t in enumerate([3, 4, 5, 6]):
        logits[0, j, t] = 10.0
    for j, t in enumerate([1, 2, 3, 7]):
        logits[1, j, t] = 10.0
    tokens = np.zeros((b, kd), np.int32)
    tokens[0] = [0, 3, 4, 9]
    tokens[1] = [0, 1, 2, 3]
    counts = np.array([4, 4, 0], np.int32)
    (jout, jn), (tout, tn) = _accept_both(logits, tokens, counts, np.zeros(b, np.float32),
                                          np.zeros(b, np.int32), np.ones(b, np.float32))
    assert tn.tolist() == [3, 4, 0] and jn.tolist() == tn.tolist()
    assert tout[0, :3].tolist() == [3, 4, 5] and tout[1].tolist() == [1, 2, 3, 7]
    np.testing.assert_array_equal(jout, tout)


@pytest.mark.parametrize("kd", [1, 2, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_bitwise_matches_jax_at_temperature_zero(kd, seed):
    """Random logits, drafts that follow the argmax chain for a random
    number of rows and then stray, random counts (some lanes inactive) and
    filter settings: every output token and count equals JAX's."""
    rng = np.random.default_rng(seed)
    b, v = 6, 50
    logits = rng.standard_normal((b, kd, v)).astype(np.float32)
    chain = logits.argmax(-1)
    tokens = rng.integers(0, v, (b, kd)).astype(np.int32)
    for lane in range(b):
        follow = rng.integers(0, kd)
        tokens[lane, 1:1 + follow] = chain[lane, :follow]
    counts = rng.integers(0, kd + 1, b).astype(np.int32)
    top_ks = rng.choice([0, 1, 5], b).astype(np.int32)
    top_ps = rng.choice([1.0, 0.5], b).astype(np.float32)
    (jout, jn), (tout, tn) = _accept_both(logits, tokens, counts, np.zeros(b, np.float32),
                                          top_ks, top_ps, seed=seed)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_array_equal(jout, tout)
    assert (tn == np.where(counts > 0, tn, 0)).all() and (tn[counts > 0] >= 1).all()


def test_accept_rejection_sampling_marginal_is_exact():
    """temperature > 0 with a point-mass draft: the FIRST emitted token's
    marginal equals the filtered target distribution (accept with
    probability p(draft), else the renormalized residual)."""
    v, draft, n = 8, 2, 20000
    logits_row = np.linspace(-1.0, 1.0, v, dtype=np.float32)[None, :]
    temps = np.array([0.7], np.float32)
    tks, tps = np.array([5], np.int64), np.array([0.9], np.float32)
    target = torch.softmax(tspec.filtered_scores(_t(logits_row), _t(temps), _t(tks), _t(tps)),
                           -1)[0].numpy()
    jtarget = np.asarray(jax.nn.softmax(jspec.filtered_scores(
        jnp.asarray(logits_row), jnp.asarray(temps), jnp.asarray(tks), jnp.asarray(tps))))[0]
    np.testing.assert_allclose(target, jtarget, atol=1e-6)
    # n independent lanes of the same round: one draw each
    logits = torch.from_numpy(np.broadcast_to(logits_row[:, None, :], (n, 2, v)).copy())
    tokens = torch.tensor([[0, draft]] * n)
    gen = torch.Generator()
    gen.manual_seed(7)
    out, n_out = tspec.accept_speculative(
        logits, tokens, torch.full((n,), 2), gen, torch.full((n,), 0.7),
        torch.full((n,), 5), torch.full((n,), 0.9))
    emp = np.bincount(out[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(emp - target).sum()
    assert tv < 0.02, (tv, emp, target)
    assert set(n_out.tolist()) <= {1, 2}


# ------------------------------------------------------ engine: exactness

REPEAT = [5, 17, 42, 7, 5, 17, 42, 7, 5, 17, 42, 7]
SINGLE_TOKENS = 16
STAGGERED = [[1, 2, 3, 1, 2, 3], [9, 8, 9, 8], [30, 31, 30, 31], [4, 4, 4], list(range(60, 80))]
COUNTERS = ("spec_proposed", "spec_accepted", "spec_rollback_pages")


def _port_plain(llama, prompts, max_tokens):
    _, _, tconfig, tparams = llama
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, paged=tpaged.PagedConfig(**PC)), device="cpu")
    try:
        return [engine.generate(p, max_tokens=max_tokens) for p in prompts]
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def plain_tokens(llama):
    single = _port_plain(llama, [REPEAT], SINGLE_TOKENS)[0]
    return single, _port_plain(llama, STAGGERED, 6)


def _proposer(kind, module, recorded, vocab):
    if kind == "ngram":
        return None  # the engine's default n-gram proposer
    if kind == "replay":
        return module.ReplayProposer({tuple(REPEAT): recorded})
    return WrongProposer(vocab)


def _drive(engine):
    """One request alone (its counters), then a staggered batch."""
    single = engine.generate(REPEAT, max_tokens=SINGLE_TOKENS)
    counts = {k: engine.stats()[k] for k in COUNTERS}
    streams = []
    for p in STAGGERED:
        streams.append(engine.submit(p, max_tokens=6))
        time.sleep(0.02)
    return single, counts, [s.result(timeout=120) for s in streams]


@pytest.fixture(scope="module")
def jax_spec_runs(llama, plain_tokens):
    """The JAX spec engine's tokens and counters per proposer, computed
    once for the module (each JAX engine compiles its passes)."""
    jconfig, jparams, _, _ = llama
    runs = {}

    def run(kind):
        if kind not in runs:
            engine = JEngine(jconfig, jparams, JEngineConfig(
                max_slots=4, speculative_tokens=SPEC,
                speculative_proposer=_proposer(kind, jspec, plain_tokens[0], jconfig.vocab_size),
                paged=jpaged.PagedConfig(**PC)))
            try:
                runs[kind] = _drive(engine)
            finally:
                engine.shutdown()
        return runs[kind]

    return run


@pytest.mark.parametrize("kind", ["ngram", "replay", "wrong"])
def test_spec_engine_matches_jax_and_plain_engine(llama, plain_tokens, jax_spec_runs, kind):
    """Greedy tokens equal the JAX spec engine's and the port's plain
    engine's, one request and a staggered batch; the single request's
    proposed / accepted / rolled-back counts equal JAX's. Every page comes
    back, and the pass runs are verify passes only."""
    _, _, tconfig, tparams = llama
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, speculative_tokens=SPEC,
        speculative_proposer=_proposer(kind, tspec, plain_tokens[0], tconfig.vocab_size),
        paged=tpaged.PagedConfig(**PC)), device="cpu")
    try:
        single, counts, staggered = _drive(engine)
        stats = engine.stats()
    finally:
        engine.shutdown()
    jsingle, jcounts, jstaggered = jax_spec_runs(kind)
    assert single == jsingle == plain_tokens[0]
    assert staggered == jstaggered == plain_tokens[1]
    assert counts == jcounts
    assert stats["pages_free"] == PC["num_pages"] - 1
    assert not any(k.startswith("passes.decode") or k.startswith("passes.mixed") for k in stats)
    # every verify round is one pass: a decode-only verify tick or a mixed
    # tick's ride-along
    verify_runs = sum(stats[f"passes.verify.{b}"] for b in (1, 2, 4))
    assert stats["mixed_ticks"] <= verify_runs <= stats["mixed_ticks"] + stats["decode_steps"]
    if kind == "replay":
        assert counts["spec_accepted"] == counts["spec_proposed"] > 0
        assert stats["decode_steps"] / stats["decode_tokens"] <= 1 / 1.8
    if kind == "ngram":
        assert counts["spec_proposed"] > 0
    if kind == "wrong":
        assert counts["spec_rollback_pages"] > 0 and counts["spec_accepted"] < counts["spec_proposed"]


def test_spec_engine_gpt2_staggered_matches_plain():
    """gpt2-tiny (learned positions, biases, tied head), staggered: the
    plain engine's greedy tokens."""
    _, _, tconfig, tparams = _converted("gpt2-tiny", seed=1)
    prompts = [[1, 2, 3, 1, 2, 3], [9, 8, 9, 8], [30, 31, 30, 31], [4, 4, 4]]
    outs = {}
    for spec in (0, SPEC):
        engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
            max_slots=4, speculative_tokens=spec, paged=tpaged.PagedConfig(**PC)), device="cpu")
        try:
            streams = []
            for p in prompts:
                streams.append(engine.submit(p, max_tokens=6))
                time.sleep(0.02)
            outs[spec] = [s.result(timeout=60) for s in streams]
        finally:
            engine.shutdown()
    assert outs[SPEC] == outs[0]


def test_spec_engine_with_draft_model_matches_plain(llama, plain_tokens):
    """The draft-model proposer (llama-tiny drafting for itself: every
    draft accepted) keeps the plain engine's greedy tokens."""
    _, _, tconfig, tparams = llama
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, speculative_tokens=SPEC,
        speculative_proposer=tspec.DraftModelProposer(tconfig, tparams, window=32),
        paged=tpaged.PagedConfig(**PC)), device="cpu")
    try:
        got = engine.generate(REPEAT, max_tokens=SINGLE_TOKENS)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert got == plain_tokens[0]
    assert stats["spec_proposed"] > 0 and stats["spec_accepted"] == stats["spec_proposed"]


def test_spec_engine_prefix_cache_and_sampling(llama, plain_tokens):
    """Speculation with the prefix cache on: a repeated prompt reuses its
    cached pages and keeps the greedy tokens; a sampled request (top-k 1 at
    temperature 0.8 is greedy) through the accept step's rejection path
    gives them too; every page not pinned by the cache comes back."""
    _, _, tconfig, tparams = llama
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, speculative_tokens=SPEC,
        paged=tpaged.PagedConfig(**dict(PC, prefix_cache=True))), device="cpu")
    try:
        first = engine.generate(REPEAT, max_tokens=SINGLE_TOKENS)
        again = engine.submit(REPEAT, max_tokens=SINGLE_TOKENS)
        top1 = engine.generate(REPEAT, max_tokens=SINGLE_TOKENS, temperature=0.8, top_k=1)
        hot = engine.generate(REPEAT, max_tokens=8, temperature=1.0)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert first == again.result(timeout=60) == top1 == plain_tokens[0]
    assert again.cached_tokens == 8 and stats["prefix_cache_hits"] >= 2
    assert len(hot) == 8 and all(0 <= t < tconfig.vocab_size for t in hot)
    assert stats["pages_free"] + stats["prefix_cache_pages"] == PC["num_pages"] - 1


def test_spec_engine_stops_mid_round_and_max_tokens_one(llama, plain_tokens):
    """A stop token or stop sequence that lands inside an accepted run of
    drafts ends the stream there (the round's later tokens are dropped),
    max_tokens=1 ends after the first token's fetch, and every page comes
    back: the plain engine's outputs, with every draft accepted."""
    _, _, tconfig, tparams = llama
    expected = plain_tokens[0]
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, speculative_tokens=SPEC,
        speculative_proposer=tspec.ReplayProposer({tuple(REPEAT): expected}),
        paged=tpaged.PagedConfig(**PC)), device="cpu")
    try:
        stop_id = engine.submit(REPEAT, max_tokens=SINGLE_TOKENS, stop_token_ids=[expected[5]])
        stop_seq = engine.submit(REPEAT, max_tokens=SINGLE_TOKENS, stop_sequences=[expected[3:6]])
        one = engine.submit(REPEAT, max_tokens=1)
        assert stop_id.result(timeout=60) == expected[: expected.index(expected[5]) + 1]
        assert stop_seq.result(timeout=60) == expected[:6]
        assert one.result(timeout=60) == expected[:1]
        deadline = time.time() + 10
        while engine.stats()["pages_free"] < PC["num_pages"] - 1:
            assert time.time() < deadline, "pages leaked"
            time.sleep(0.01)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert stats["spec_accepted"] == stats["spec_proposed"] > 0


PRESSURE_PC = dict(page_size=8, num_pages=6, max_pages_per_slot=4, chunk_pages=1)
PRESSURE_PROMPTS = [[int(t) for t in np.random.default_rng(70 + i).integers(1, 200, size=12)]
                    for i in range(6)]
PRESSURE_PROMPTS += PRESSURE_PROMPTS[:2]  # repeats, for the prefix cache


@pytest.fixture(scope="module")
def pressure_tokens(llama):
    _, _, tconfig, tparams = llama
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=2, paged=tpaged.PagedConfig(**dict(PRESSURE_PC, num_pages=64))), device="cpu")
    try:
        return [engine.generate(p, max_tokens=12) for p in PRESSURE_PROMPTS]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("kind,prefix_cache,inflight", [
    ("wrong", False, 1), ("wrong", True, 8), ("replay", True, 1), ("replay", False, 8)])
def test_spec_engine_under_page_pressure(llama, pressure_tokens, kind, prefix_cache, inflight):
    """More demand than pages (5 allocatable for 2 lanes that need 3 each),
    with rounds that grow and roll back pages (wrong drafts) or accept
    whole rounds (replay), with and without the prefix cache, at 1 and 8
    blocks in flight: admissions, growth and rounds wait on the allocator,
    every request gets the plain engine's tokens, and every page not
    pinned by the cache comes back."""
    _, _, tconfig, tparams = llama
    proposer = (WrongProposer(tconfig.vocab_size) if kind == "wrong" else
                tspec.ReplayProposer({tuple(p): o for p, o in
                                      zip(PRESSURE_PROMPTS, pressure_tokens)}))
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=2, speculative_tokens=SPEC, speculative_proposer=proposer,
        max_inflight_blocks=inflight,
        paged=tpaged.PagedConfig(**dict(PRESSURE_PC, prefix_cache=prefix_cache))), device="cpu")
    try:
        streams = [engine.submit(p, max_tokens=12) for p in PRESSURE_PROMPTS]
        got = [s.result(timeout=120) for s in streams]
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert got == pressure_tokens
    assert stats["page_stalls"] > 0 and stats["spec_proposed"] > 0
    assert stats["pages_free"] + stats.get("prefix_cache_pages", 0.0) == PRESSURE_PC["num_pages"] - 1
    if kind == "wrong":
        assert stats["spec_rollback_pages"] > 0
    else:
        assert stats["spec_accepted"] == stats["spec_proposed"]


def test_spec_metrics_in_stats(llama):
    _, _, tconfig, tparams = llama
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, speculative_tokens=SPEC, paged=tpaged.PagedConfig(**PC)), device="cpu")
    try:
        engine.generate([5, 17, 42, 7, 5, 17, 42, 7], max_tokens=12)
        stats = engine.stats()
    finally:
        engine.shutdown()
    for key in ("spec_proposed", "spec_accepted", "spec_acceptance_rate", "spec_rollback_pages",
                "prefix_cache_hits", "prefix_cache_cow"):
        assert key in stats, key
    assert 0.0 <= stats["spec_acceptance_rate"] <= 1.0


def test_broken_proposer_degrades_to_plain_rounds(llama, plain_tokens):
    """A proposer that raises gives plain 1-token rounds (JAX's semantics):
    the greedy tokens, nothing proposed."""

    class Broken:
        def propose(self, context, k):
            raise RuntimeError("draft model failed")

    _, _, tconfig, tparams = llama
    engine = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, speculative_tokens=SPEC, speculative_proposer=Broken(),
        paged=tpaged.PagedConfig(**PC)), device="cpu")
    try:
        got = engine.generate(REPEAT, max_tokens=SINGLE_TOKENS)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert got == plain_tokens[0] and stats["spec_proposed"] == 0
    assert stats["decode_steps"] == SINGLE_TOKENS - 1


# ----------------------------------------------- rollback vs sharing (manual)


@pytest.fixture
def manual_spec_engines(monkeypatch, llama):
    """A JAX and a port spec engine with the prefix cache, whose loops
    never run: the test drives admission, ticks, rounds and drains."""
    monkeypatch.setattr(JEngine, "_loop", lambda self: None)
    monkeypatch.setattr(PagedLLMEngine, "_loop", lambda self: None)
    jconfig, jparams, tconfig, tparams = llama
    pc = dict(PC, prefix_cache=True)
    engines = [
        JEngine(jconfig, jparams, JEngineConfig(
            max_slots=4, speculative_tokens=SPEC,
            speculative_proposer=WrongProposer(jconfig.vocab_size),
            paged=jpaged.PagedConfig(**pc))),
        PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
            max_slots=4, speculative_tokens=SPEC,
            speculative_proposer=WrongProposer(tconfig.vocab_size),
            paged=tpaged.PagedConfig(**pc)), device="cpu"),
    ]
    yield engines
    for engine in engines:
        engine.shutdown()


def _prefill_and_seed(engine, prompt):
    """Admit, prefill every chunk, then drain the "first" fetch that seeds
    the draft context."""
    engine.submit(prompt, max_tokens=8)
    engine._admit()
    slot = engine.slots[0]
    tick = getattr(engine, "_prefill_tick", None) or engine._mixed_tick
    while slot.prefilling:
        assert tick()
    deadline = time.time() + 30
    while slot.spec_ctx is None:
        engine._pump_completed(wait=True)
        assert time.time() < deadline, "first token never arrived"
    return slot


def _run_one_round(engine, slot):
    assert engine._dispatch_spec_verify()
    deadline = time.time() + 30
    while slot.spec_inflight:
        engine._pump_completed(wait=True)
        assert time.time() < deadline, "verify round never drained"


def test_spec_rollback_never_touches_prefix_shared_page(manual_spec_engines):
    """A fully rejected round that grew a fresh page trims exactly that
    page; the prompt page pinned by the prefix cache (and held by a
    manufactured second holder) keeps every ref. Same observations as the
    JAX engine."""
    seen = []
    for engine in manual_spec_engines:
        prompt = [int(t) for t in np.random.default_rng(5).integers(1, 200, size=14)]
        slot = _prefill_and_seed(engine, prompt)
        obs = [slot.position, len(slot.pages)]
        shared = slot.pages[0]  # full prompt page, cache-pinned
        obs.append(engine.allocator.refcount(shared))
        engine.allocator.share([shared])
        free_before = engine.allocator.available
        _run_one_round(engine, slot)  # writes 14..17: grows page 2, rejects, trims it
        obs += [engine.metrics["spec_rollback_pages"], slot.position, len(slot.pages),
                engine.allocator.available - free_before, engine.allocator.refcount(shared),
                int(engine.block_tables[0, 2])]
        engine.allocator.free([shared])
        seen.append(obs)
    assert seen[0] == seen[1] == [14, 2, 2, 1.0, 15, 2, 0, 3, 0]


def test_spec_round_cow_copies_shared_write_page_then_rolls_back(manual_spec_engines):
    """The round's write range includes a SHARED partial page: the engine
    copies it before dispatch (the original keeps its other holder), then
    rollback frees only the round's fresh growth; the original is never
    freed twice. Same observations as the JAX engine."""
    seen = []
    for engine in manual_spec_engines:
        prompt = [int(t) for t in np.random.default_rng(6).integers(1, 200, size=14)]
        slot = _prefill_and_seed(engine, prompt)
        victim = slot.pages[1]  # the partial page the round writes first
        obs = [engine.allocator.refcount(victim)]
        engine.allocator.share([victim])
        _run_one_round(engine, slot)
        obs += [engine.metrics["prefix_cache_cow"], slot.pages[1] != victim,
                engine.allocator.refcount(victim), engine.allocator.refcount(slot.pages[1]),
                engine.metrics["spec_rollback_pages"],
                int(engine.block_tables[0, 1]) == slot.pages[1]]
        engine.allocator.free([victim])  # last holder: recycles cleanly
        obs.append(engine.allocator.refcount(victim))
        seen.append(obs)
    assert seen[0] == seen[1] == [1, 1.0, True, 1, 1, 1.0, True, 0]
