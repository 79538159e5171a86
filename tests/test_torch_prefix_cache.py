"""ray_tpu_torch's prefix cache against ray_tpu's on the CPU.

The host structures (the refcounted `PageAllocator`, `PrefixCache`) run
the same sequence of operations in both packages and must report the same
pages, refcounts, lookups, evictions and stats; `copy_page` must equal the
JAX function bit for bit. The engines run llama-tiny at f32 on weights
converted from the JAX init (`params_from_numpy`): at temperature 0 a
request that reuses cached pages must emit the plain engine's tokens and
count the JAX engine's hits. Copy-on-write is forced by sharing a page by
hand, as the JAX package's own tests do, since the engine never writes a
shared page by itself.
"""

import functools

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

PC = dict(page_size=8, num_pages=64, max_pages_per_slot=8, chunk_pages=2, prefix_cache=True)
BOTH = [jpaged, tpaged]


def _prompt(seed, n, lo=1, hi=200):
    return [int(t) for t in np.random.default_rng(seed).integers(lo, hi, size=n)]


# ----------------------------------------------------------------- allocator


def _refcount_case(m):
    a = m.PageAllocator(num_pages=8)
    pages = a.alloc(2)
    seen = [list(pages), a.refcount(pages[0])]
    a.share([pages[0]])
    seen.append(a.refcount(pages[0]))
    a.free(pages)  # slot retires: the shared page keeps one holder
    seen += [a.refcount(pages[0]), a.refcount(pages[1]), a.available]
    a.free([pages[0]])  # last holder lets go: the page recycles
    seen += [a.available, sorted(a.alloc(7))]
    return seen


def _share_unallocated_case(m):
    a = m.PageAllocator(num_pages=4)
    seen = []
    with pytest.raises(ValueError, match="unallocated"):
        a.share([2])
    p = a.alloc(1)
    a.free(p)
    with pytest.raises(ValueError, match="unallocated"):
        a.share(p)  # freed: resurrecting it would corrupt the next owner
    seen += [list(p), a.available]
    return seen


def _scratch_case(m):
    a = m.PageAllocator(num_pages=4)
    a.share([0])
    a.free([0])
    a.free([0])
    return [a.refcount(0), a.available, sorted(a.alloc(3))]


def _double_free_case(m):
    a = m.PageAllocator(num_pages=4)
    p = a.alloc(1)
    a.free(p)
    a.free(p)  # a second free is ignored, not a second free-list entry
    return [a.available, sorted(a.alloc(3))]


ALLOCATOR_CASES = {
    "refcount_freed_at_last_holder": (_refcount_case, [[1, 2], 1, 2, 1, 0, 6, 7, [1, 2, 3, 4, 5, 6, 7]]),
    "share_of_unallocated_raises": (_share_unallocated_case, [[1], 3]),
    "scratch_never_refcounted": (_scratch_case, [0, 3, [1, 2, 3]]),
    "double_free_guard": (_double_free_case, [3, [1, 2, 3]]),
}


@pytest.mark.parametrize("case", list(ALLOCATOR_CASES))
def test_allocator_matches_jax(case):
    """The same operations on JAX's allocator and the port's: the same
    pages, refcounts and free counts (and the values JAX's tests hold)."""
    fn, expected = ALLOCATOR_CASES[case]
    got = [fn(m) for m in BOTH]
    assert got[0] == got[1] == expected


# -------------------------------------------------------------- prefix cache


def _lookup_case(m):
    a = m.PageAllocator(num_pages=16)
    cache = m.PrefixCache(a, page_size=4)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    pages = a.alloc(2)
    seen = [cache.register(prompt, pages), a.refcount(pages[0])]
    seen += [cache.lookup(prompt), a.refcount(pages[0])]  # one token left to prefill
    seen += [cache.lookup(prompt + [9]), cache.stats(), cache.chain_heads()]
    return seen


def _divergent_case(m):
    a = m.PageAllocator(num_pages=16)
    cache = m.PrefixCache(a, page_size=4)
    pages = a.alloc(3)
    cache.register(list(range(1, 13)), pages)
    return [cache.lookup([1, 2, 3, 4, 99, 6, 7, 8, 9, 10, 11, 12, 13]), list(pages),
            cache.stats()]


def _eviction_case(m):
    a = m.PageAllocator(num_pages=16)
    cache = m.PrefixCache(a, page_size=4)
    pa, pb = a.alloc(1), a.alloc(1)
    cache.register([1, 2, 3, 4], pa)
    cache.register([5, 6, 7, 8], pb)
    a.free(pa)
    a.free(pb)  # both held only by the cache now
    a.share(pa)  # ...then a live slot pins the LRU entry
    seen = [cache.evict(2), a.refcount(pa[0]), a.refcount(pb[0])]
    seen += [cache.lookup([1, 2, 3, 4, 0]) == pa, cache.stats(), len(cache)]
    return seen


def _capacity_case(m):
    a = m.PageAllocator(num_pages=16)
    cache = m.PrefixCache(a, page_size=4, capacity_pages=2)
    pages = a.alloc(3)
    seen = [cache.register(list(range(1, 13)), pages), len(cache), a.refcount(pages[2])]
    a.free(pages)  # the slot retires: only the cache's pins remain
    other = a.alloc(1)
    seen += [cache.register([9, 9, 9, 9], other), len(cache), cache.stats(),
             cache.chain_heads()]
    return seen


def _pressure_case(m):
    """Many prompts sharing and diverging, lookups, frees and evictions
    under a small pool: every observation in order."""
    rng = np.random.default_rng(3)
    a = m.PageAllocator(num_pages=24)
    cache = m.PrefixCache(a, page_size=4, capacity_pages=9)
    base = [int(t) for t in rng.integers(1, 50, 12)]
    held, seen = [], []
    for i in range(10):
        prompt = base[: 4 * (i % 3)] + [int(t) for t in rng.integers(1, 50, 5 + i)]
        hit = cache.lookup(prompt)
        fresh = a.alloc(-(-len(prompt) // 4) - len(hit))
        if fresh is None:
            seen.append(("evicted", cache.evict(4)))
            fresh = a.alloc(-(-len(prompt) // 4) - len(hit)) or []
        pages = hit + fresh
        seen.append((hit, cache.register(prompt, pages), a.available))
        held.append(pages)
        if i % 2:
            a.free(held.pop(0))
    seen += [cache.stats(), cache.chain_heads(), [a.refcount(p) for p in range(24)]]
    return seen


CACHE_CASES = {
    "lookup_leaves_one_token": _lookup_case,
    "lookup_stops_at_divergent_page": _divergent_case,
    "eviction_lru_skips_pinned": _eviction_case,
    "capacity_cap": _capacity_case,
    "pressure_sequence": _pressure_case,
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_prefix_cache_matches_jax(case):
    """The same operations on JAX's PrefixCache and the port's: the same
    lookups, registrations, evictions, refcounts, stats and chain heads."""
    jax_seen, torch_seen = (CACHE_CASES[case](m) for m in BOTH)
    assert jax_seen == torch_seen


def test_lookup_leaves_one_token_and_caps_like_jax():
    """JAX's own expectations, on the port: an 8-token prompt of 2 full
    pages reuses one page; a longer prompt reuses both."""
    a = tpaged.PageAllocator(num_pages=16)
    cache = tpaged.PrefixCache(a, page_size=4)
    pages = a.alloc(2)
    assert cache.register([1, 2, 3, 4, 5, 6, 7, 8], pages) == 2
    assert cache.lookup([1, 2, 3, 4, 5, 6, 7, 8]) == [pages[0]]
    assert a.refcount(pages[0]) == 3
    assert cache.lookup([1, 2, 3, 4, 5, 6, 7, 8, 9]) == pages
    assert cache.stats()["hits"] == 3.0


def test_chain_hash_matches_jax():
    prev = b""
    for chunk in ([1, 2, 3], [7] * 64, list(range(100, 164))):
        assert jpaged._chain_hash(prev, chunk) == tpaged._chain_hash(prev, chunk)
        prev = tpaged._chain_hash(prev, chunk)


# ------------------------------------------------------------------ copy_page


@pytest.mark.parametrize("src,dst", [(3, 7), (1, 2), (9, 1)])
def test_copy_page_bitwise_matches_jax(src, dst):
    """Every layer's stripe of page src lands on page dst; nothing else
    moves. Bitwise against JAX's copy_page."""
    n_layers, num_pages = 3, 10
    rng = np.random.default_rng(src * 10 + dst)
    shape = (2, n_layers * num_pages, 4, 8)
    pool = {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}
    jout = jax.jit(functools.partial(jpaged.copy_page, n_layers=n_layers))(
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.int32(src), jnp.int32(dst))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tout = tpaged.copy_page(tcache, src, dst, n_layers=n_layers)
    assert tout is tcache  # in place
    for k in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(jout[k]), tout[k].numpy())
        moved = np.flatnonzero((tout[k].numpy() != pool[k]).any(axis=(0, 2, 3)))
        assert set(moved) <= {dst + i * num_pages for i in range(n_layers)}


# ------------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def weights():
    jconfig = jmodels.get_config("llama-tiny")
    jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(0))
    tconfig = tmodels.get_config("llama-tiny")
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams), tconfig, device="cpu")
    return jconfig, jparams, tconfig, tparams


def _engines(weights, pc=PC, max_slots=4):
    jconfig, jparams, tconfig, tparams = weights
    jeng = JEngine(jconfig, jparams,
                   JEngineConfig(max_slots=max_slots, paged=jpaged.PagedConfig(**pc)))
    teng = PagedLLMEngine(tconfig, tparams,
                          PagedEngineConfig(max_slots=max_slots, paged=tpaged.PagedConfig(**pc)),
                          device="cpu")
    return jeng, teng


PREFIX_KEYS = ("prefix_cache_hits", "prefix_cache_misses", "prefix_cache_pages",
               "prefix_cache_evictions", "prefix_cache_cow")


def test_engine_prefix_reuse_matches_plain_and_counts_jax_hits(weights):
    """A repeated prompt and a shared-prefix prompt reuse cached pages and
    still emit the plain engine's greedy tokens (and the JAX engine's);
    the hit, miss, page and eviction counts equal the JAX engine's after
    every request. The reusing requests start prefill past the cached
    pages, and report it in `cached_tokens`."""
    _, _, tconfig, tparams = weights
    prompt = _prompt(5, 20)
    forked = prompt[:16] + _prompt(9, 8)
    requests = [prompt, prompt, forked]
    plain = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=4, paged=tpaged.PagedConfig(**dict(PC, prefix_cache=False))), device="cpu")
    try:
        expected = [plain.generate(p, max_tokens=6) for p in requests]
    finally:
        plain.shutdown()
    jeng, teng = _engines(weights)
    try:
        for p, want in zip(requests, expected):
            assert jeng.generate(p, max_tokens=6) == want
            stream = teng.submit(p, max_tokens=6)
            assert stream.result(timeout=60) == want
            jstats, tstats = jeng.stats(), teng.stats()
            assert {k: tstats[k] for k in PREFIX_KEYS} == {k: jstats[k] for k in PREFIX_KEYS}
        assert stream.cached_tokens == 16 and tstats["prefix_cache_hits"] == 4.0
        assert tstats["prefix_cache_pages"] >= 2.0
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_engine_alloc_under_pressure_evicts_cache_not_admissions(weights):
    """A starved free list with cache-pinned pages: admission evicts LRU
    cache pages instead of stalling behind retired prompts, in both
    packages, and the request gets the plain engine's tokens."""
    pc = dict(page_size=8, num_pages=10, max_pages_per_slot=4, chunk_pages=1, prefix_cache=True)
    _, _, tconfig, tparams = weights
    prompt, fresh = _prompt(1, 16), _prompt(2, 8, 200, 256)
    plain = PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
        max_slots=2, paged=tpaged.PagedConfig(**dict(pc, prefix_cache=False))), device="cpu")
    try:
        want = plain.generate(fresh, max_tokens=4)
    finally:
        plain.shutdown()
    seen = []
    for engine in _engines(weights, pc, max_slots=2):
        try:
            engine.generate(prompt, max_tokens=4)
            pinned = engine.stats()["prefix_cache_pages"]
            hoard = engine.allocator.alloc(engine.allocator.available)
            got = engine.submit(fresh, max_tokens=4).result(timeout=60)
            seen.append((pinned, got, engine.stats()["prefix_cache_evictions"]))
            engine.allocator.free(hoard)
        finally:
            engine.shutdown()
    assert seen[0] == seen[1]
    assert seen[1][0] >= 2.0 and seen[1][1] == want and seen[1][2] >= 1.0


# -------------------------------------------- copy-on-write (manual engines)


@pytest.fixture
def manual_engines(monkeypatch, weights):
    """One JAX and one port engine whose loops never run: the test drives
    admission, ticks and drains by hand."""
    monkeypatch.setattr(JEngine, "_loop", lambda self: None)
    monkeypatch.setattr(PagedLLMEngine, "_loop", lambda self: None)
    engines = _engines(weights)
    yield engines
    for engine in engines:
        engine.shutdown()


def _prefill_by_hand(engine, prompt):
    engine.submit(prompt, max_tokens=4)
    engine._admit()
    slot = engine.slots[0]
    tick = getattr(engine, "_prefill_tick", None) or engine._mixed_tick
    while slot.prefilling:
        assert tick()
    return slot


def test_cow_guard_copies_shared_page_and_drops_ref(manual_engines):
    """_ensure_private_page on a shared page: a fresh page with the same KV
    takes its place in the block table, the shared original keeps its other
    holders, and the COW metric ticks; private pages do not copy. The same
    pages and refcounts as the JAX engine."""
    seen = []
    for engine in manual_engines:
        slot = _prefill_by_hand(engine, [5, 17, 42, 7, 3, 11, 9, 2, 8])
        victim = slot.pages[0]
        obs = [victim, engine.allocator.refcount(victim)]  # 2: the cache pins it
        engine.allocator.share([victim])  # another holder
        before = {k: np.asarray(v).copy() for k, v in engine.cache.items()}
        assert engine._ensure_private_page(0, slot, 0)
        fresh = slot.pages[0]
        obs += [fresh, int(engine.block_tables[0, 0]), engine.allocator.refcount(victim),
                engine.allocator.refcount(fresh), engine.metrics["prefix_cache_cow"]]
        assert engine._ensure_private_page(0, slot, 0)  # private now: no copy
        obs.append(engine.metrics["prefix_cache_cow"])
        n_layers = engine.model_config.n_layers
        num_pages = engine.paged.num_pages
        for k, pool in before.items():
            after = np.asarray(engine.cache[k])
            for i in range(n_layers):
                np.testing.assert_array_equal(after[:, fresh + i * num_pages],
                                              pool[:, victim + i * num_pages])
        engine.allocator.free([victim])
        seen.append(obs)
    assert seen[0] == seen[1]
    victim, refs, fresh, table, victim_refs, fresh_refs, cow, cow_again = seen[1]
    assert refs == 2 and fresh != victim and table == fresh
    assert (victim_refs, fresh_refs, cow, cow_again) == (2, 1, 1.0, 1.0)


def test_cow_guard_stalls_lane_when_pool_exhausted(manual_engines):
    seen = []
    for engine in manual_engines:
        slot = _prefill_by_hand(engine, [5, 17, 42, 7, 3, 11, 9, 2, 8])
        engine.allocator.share([slot.pages[0]])
        hoard = engine.allocator.alloc(engine.allocator.available)
        ok = engine._ensure_private_page(0, slot, 0)
        seen.append((ok, slot.stalled, engine.metrics["page_stalls"],
                     engine.metrics["prefix_cache_cow"]))
        engine.allocator.free(hoard)
        engine.allocator.free([slot.pages[0]])
    assert seen[0] == seen[1] == [(False, True, 1.0, 0.0)][0]
