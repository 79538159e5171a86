"""Overload handling of ray_tpu_torch's engines against ray_tpu's on the CPU.

Admission sheds (the queue bound, tenant quotas), deadlines (before
submit, at the admit pop, mid-decode), priority order at admission and
lane preemption (a slot wedge, page pressure, the config gate, a victim
with blocks or a verify round in flight, prefix-shared pages) run on
llama-tiny at f32 on weights converted from the JAX init. Every engine's
loop is patched out and the test drives admission, ticks, dispatch and
drains by hand, so no outcome depends on where a thread happens to be:
the same steps on the JAX engine and the port's must give the same
observations, and a resumed greedy stream must equal the unpreempted
greedy reference exactly.
"""

import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu import models as jmodels
from ray_tpu.core.config import cfg as jcfg
from ray_tpu.core.exceptions import BackPressureError as JBackPressure
from ray_tpu.core.exceptions import RequestTimeoutError as JTimeout
from ray_tpu.serve import tenancy as jtenancy
from ray_tpu.serve.llm import engine as jengine
from ray_tpu.serve.llm import paged as jpaged
from ray_tpu.serve.llm.paged_engine import PagedEngineConfig as JEngineConfig
from ray_tpu.serve.llm.paged_engine import PagedLLMEngine as JEngine
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.core.config import cfg as tcfg
from ray_tpu_torch.core.exceptions import BackPressureError, RequestTimeoutError
from ray_tpu_torch.serve import tenancy as ttenancy
from ray_tpu_torch.serve.llm import engine as tengine
from ray_tpu_torch.serve.llm import paged as tpaged
from ray_tpu_torch.serve.llm.paged_engine import PagedEngineConfig, PagedLLMEngine

PC = dict(page_size=8, num_pages=64, max_pages_per_slot=8, chunk_pages=2)
TIMEOUTS = {"jax": JTimeout, "torch": RequestTimeoutError}
SHEDS = {"jax": JBackPressure, "torch": BackPressureError}


class WrongProposer:
    """Drafts walk a +1 ring the greedy chain almost never follows, so
    nearly every verify round rejects at its first draft."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def propose(self, context, k):
        return [(context[-1] + 1 + i) % self.vocab for i in range(k)]


@pytest.fixture(autouse=True)
def _clean():
    for m in (jtenancy, ttenancy):
        m.reset()
    yield
    for m in (jtenancy, ttenancy):
        m.reset()
    jcfg.reset()
    tcfg.reset()


@pytest.fixture(scope="module")
def llama():
    jconfig = jmodels.get_config("llama-tiny")
    jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(0))
    tconfig = tmodels.get_config("llama-tiny")
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams), tconfig, device="cpu")
    return jconfig, jparams, tconfig, tparams


@pytest.fixture
def manual(monkeypatch, llama):
    """Builds a (JAX, port) pair of paged engines whose loops never run."""
    monkeypatch.setattr(JEngine, "_loop", lambda self: None)
    monkeypatch.setattr(PagedLLMEngine, "_loop", lambda self: None)
    jconfig, jparams, tconfig, tparams = llama
    built = []

    def make(pc=None, proposer=False, **kw):
        pc = dict(PC, **(pc or {}))
        spec = dict(speculative_tokens=3,
                    speculative_proposer=WrongProposer(tconfig.vocab_size)) if proposer else {}
        pair = [
            ("jax", JEngine(jconfig, jparams, JEngineConfig(
                paged=jpaged.PagedConfig(**pc), **spec, **kw))),
            ("torch", PagedLLMEngine(tconfig, tparams, PagedEngineConfig(
                paged=tpaged.PagedConfig(**pc), **spec, **kw), device="cpu")),
        ]
        built.extend(e for _, e in pair)
        return pair

    yield make
    for engine in built:
        engine.shutdown()


@pytest.fixture
def manual_dense(monkeypatch, llama):
    """A (JAX, port) pair of dense engines whose loops never run."""
    monkeypatch.setattr(jengine.LLMEngine, "_loop", lambda self: None)
    monkeypatch.setattr(tengine.LLMEngine, "_loop", lambda self: None)
    jconfig, jparams, tconfig, tparams = llama
    pair = [("jax", jengine.LLMEngine(jconfig, jparams, jengine.EngineConfig(max_slots=1,
                                                                             max_seq=64))),
            ("torch", tengine.LLMEngine(tconfig, tparams,
                                        tengine.EngineConfig(max_slots=1, max_seq=64),
                                        device="cpu"))]
    yield pair
    for _, engine in pair:
        engine.shutdown()


def _greedy(llama, prompt, n):
    _, _, tconfig, tparams = llama
    tokens = list(prompt)
    for _ in range(n):
        logits = tmodels.forward(tparams, torch.tensor([tokens]), tconfig)
        tokens.append(int(torch.argmax(logits[0, -1])))
    return tokens[len(prompt):]


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 200, size=n)]


def _drain(engine):
    """Emit every fetch in flight."""
    deadline = time.time() + 30
    while engine._inflight:
        engine._pump_completed(wait=True)
        assert time.time() < deadline, "a fetch never drained"


def _step(engine):
    """One iteration of the engine loop by hand: admit, sweep deadlines,
    one mixed tick or one decode dispatch (a verify round in speculative
    mode), then drain everything in flight and retire what finished."""
    engine._admit()
    engine._deadline_sweep()
    if not engine._mixed_tick():
        (engine._dispatch_spec_verify if engine.spec_tokens else engine._dispatch_decode_block)()
    _drain(engine)
    for i, slot in enumerate(engine.slots):
        if slot.request is not None and not slot.prefilling:
            engine._maybe_retire(i, slot.request)


def _collect(stream, out):
    """Move every token already in the stream's queue into `out`; True once
    the stream has ended."""
    q = stream._request.out
    while not q.empty():
        item = q.get_nowait()
        if item is None:
            return True
        if isinstance(item, BaseException):
            out.append(type(item).__name__)
            continue
        out.append(item)
    return False


def _run(engine, streams, outs, limit=400):
    done = [False] * len(streams)
    for _ in range(limit):
        done = [d or _collect(s, o) for d, s, o in zip(done, streams, outs)]
        if all(done):
            return
        _step(engine)
    raise AssertionError("the streams did not end")


def _decode_until(engine, stream, out, emitted):
    """Step until the stream has emitted `emitted` tokens; nothing is in
    flight afterwards (each step drains)."""
    for _ in range(200):
        _collect(stream, out)
        if len(out) >= emitted:
            return
        _step(engine)
    raise AssertionError("the lane never reached its tokens")


def _pool_full(engine):
    stats = engine.stats()
    return stats["pages_free"] + stats.get("prefix_cache_pages", 0.0) == engine.paged.num_pages - 1


# --------------------------------------------------------------- admission


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_queue_bound_sheds_typed(manual, manual_dense, kind):
    """Past max_queued_requests the submit raises the typed shed (no
    retry estimate), counted in `shed`; the queued requests stay."""
    seen = []
    if kind == "paged":
        pairs = manual(max_slots=1, max_queued_requests=2)
    else:
        pairs = manual_dense
        for _, engine in pairs:
            engine.config.max_queued_requests = 2
    for name, engine in pairs:
        engine.submit([1, 2, 3], max_tokens=2)
        engine.submit([4, 5, 6], max_tokens=2)
        with pytest.raises(SHEDS[name]) as info:
            engine.submit([7, 8, 9], max_tokens=2)
        seen.append((info.value.retry_after_s, engine.metrics["shed"], engine._queue.qsize()))
    assert seen[0] == seen[1] == (None, 1.0, 2)


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_quota_sheds_typed_with_retry_after(manual, manual_dense, kind):
    """A tenant over its token bucket sheds with the bucket's refill time;
    other tenants are unaffected."""
    from ray_tpu.util import metrics as jmetrics
    from ray_tpu_torch.util import metrics as tmetrics

    pairs = manual(max_slots=1) if kind == "paged" else manual_dense
    seen, counters = [], []
    for (name, engine), m, metrics in zip(pairs, (jtenancy, ttenancy), (jmetrics, tmetrics)):
        metrics.registry().clear()
        m.set_tenant("free", quota_rps=0.1, quota_burst=1.0)
        engine.submit([3, 1, 4], max_tokens=2, tenant="free")
        with pytest.raises(SHEDS[name]) as info:
            engine.submit([3, 1, 4], max_tokens=2, tenant="free")
        engine.submit([2, 7, 1], max_tokens=2, tenant="other")
        seen.append((info.value.retry_after_s, engine.metrics["shed"], engine._queue.qsize()))
        counters.append({
            metric: {tags["tenant"]: v for tags, v in metrics.registry().get(metric).collect()}
            for metric in ("raytpu_serve_tenant_shed_total", "raytpu_serve_tenant_requests_total")
        })
    for retry, shed, queued in seen:
        assert 9.0 < retry <= 10.0 and shed == 1.0 and queued == 2
    assert seen[0][0] == pytest.approx(seen[1][0], abs=0.5)
    assert counters[0] == counters[1] == {
        "raytpu_serve_tenant_shed_total": {"free": 1.0},
        "raytpu_serve_tenant_requests_total": {"free": 1.0, "other": 1.0}}


def test_priority_orders_admission_without_preemption(manual):
    """preemption off, one slot: behind a running blocker, a later
    priority-1 request is admitted before earlier priority-0 backlog,
    which then drains in its fair order. The same admission order as
    JAX's engine."""
    jcfg.set(serve_lane_preemption=False)
    tcfg.set(serve_lane_preemption=False)
    seen = []
    for _, engine in manual(max_slots=1, decode_block_steps=2):
        blocker = engine.submit(_prompt(1, 9), max_tokens=6, tenant="blk")
        out = []
        _decode_until(engine, blocker, out, 2)
        lows = [engine.submit([5, 5, i], max_tokens=2, tenant="bulk", priority=0)
                for i in range(3)]
        high = engine.submit([8, 8, 8], max_tokens=2, tenant="paid", priority=1)
        order = []
        streams = [blocker] + lows + [high]
        outs = [out] + [[] for _ in lows] + [[]]
        done = [False] * len(streams)
        for _ in range(400):
            done = [d or _collect(s, o) for d, s, o in zip(done, streams, outs)]
            if all(done):
                break
            rid = engine.slots[0].request.rid if engine.slots[0].request else None
            if rid is not None and rid not in order:
                order.append(rid)
            _step(engine)
        seen.append((order, outs, engine.metrics["lane_preemptions"]))
    assert seen[0] == seen[1]
    order, outs, preemptions = seen[1]
    assert order == [0, 4, 1, 2, 3] and preemptions == 0
    assert all(len(o) == 2 for o in outs[1:]) and len(outs[0]) == 6


# ---------------------------------------------------------------- deadlines


def test_expired_before_submit_fails_fast(manual, manual_dense):
    for name, engine in manual(max_slots=1) + manual_dense:
        with pytest.raises(TIMEOUTS[name]):
            engine.submit([1, 2, 3], max_tokens=2, deadline_ts=time.time() - 1.0)
        assert engine.metrics["timeouts"] == 1.0 and engine._queue.qsize() == 0


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_expired_at_admit_pop_never_takes_the_slot(manual, manual_dense, kind):
    """A request whose deadline passes while it queues fails at the admit
    pop with the typed error; the live request behind it gets the slot."""
    pairs = manual(max_slots=1) if kind == "paged" else manual_dense
    seen = []
    for name, engine in pairs:
        doomed = engine.submit([4, 5, 6], max_tokens=4, deadline_ts=time.time() + 0.05)
        live = engine.submit([6, 5, 4], max_tokens=2)
        time.sleep(0.1)
        engine._admit()
        with pytest.raises(TIMEOUTS[name]):
            doomed.result(timeout=10)
        seen.append((engine.slots[0].request is live._request, engine.metrics["timeouts"]))
    assert seen[0] == seen[1] == (True, 1.0)


def test_expired_mid_decode_evicts_the_paged_lane(manual, llama):
    """A deadline that passes mid-decode: the stream keeps the tokens it
    emitted, then raises the typed error; the lane's pages return."""
    prompt = _prompt(2, 13)
    seen = []
    for name, engine in manual(max_slots=2, decode_block_steps=2):
        stream = engine.submit(prompt, max_tokens=20, deadline_ts=time.time() + 600)
        other = engine.submit(_prompt(3, 5), max_tokens=8)
        out, other_out = [], []
        _decode_until(engine, stream, out, 5)
        engine.slots[0].request.deadline_ts = time.time() - 1.0
        _run(engine, [stream, other], [out, other_out])
        seen.append((out, other_out, engine.metrics["timeouts"], _pool_full(engine)))
    assert seen[0] == seen[1]
    out, other_out, timeouts, full = seen[1]
    assert out[-1] == "RequestTimeoutError" and out[:-1] == _greedy(llama, prompt, len(out) - 1)
    assert other_out == _greedy(llama, _prompt(3, 5), 8)
    assert timeouts == 1.0 and full


def test_expired_mid_decode_evicts_the_dense_lane(manual_dense, llama):
    prompt = _prompt(2, 13)
    seen = []
    for name, engine in manual_dense:
        stream = engine.submit(prompt, max_tokens=20, deadline_ts=time.time() + 600)
        engine._admit()
        for _ in range(3):
            engine._decode_round()
        engine.slots[0].request.deadline_ts = time.time() - 1.0
        engine._deadline_sweep()
        out = []
        assert _collect(stream, out)
        seen.append((out, engine.metrics["timeouts"], engine.slots[0].free))
    assert seen[0] == seen[1]
    assert seen[1][0] == _greedy(llama, prompt, 4) + ["RequestTimeoutError"]


# --------------------------------------------------------------- preemption


def _wedge(engine, victim_prompt, victim_tokens, emitted, high_prompt, high_tokens):
    victim = engine.submit(victim_prompt, max_tokens=victim_tokens, tenant="bulk", priority=0)
    vout = []
    _decode_until(engine, victim, vout, emitted)
    high = engine.submit(high_prompt, max_tokens=high_tokens, tenant="paid", priority=1)
    return victim, vout, high


def test_slot_wedge_preempts_and_the_victim_resumes_token_exact(manual, llama):
    """One slot, a low-priority lane decoding with nothing in flight: a
    priority-1 submit parks it at once (its emitted tokens folded into its
    prompt, its pages freed) and takes the slot; the victim resumes after
    it and both streams equal the unpreempted greedy reference.

    The parked lane's page count differs by rule: JAX grows a prefill chunk
    to its whole page window (the 20-token prompt's second chunk, at offset
    16, takes pages 2-3: 4 pages), the port only to the pages the prompt
    needs (3); the 5 emitted tokens' positions 20-23 fit in page 2, so the
    port parks 3 pages and its pool then has one page more free."""
    vp, hp = _prompt(4, 20), _prompt(5, 8)
    seen, page_counts = [], []
    for _, engine in manual(max_slots=1, decode_block_steps=2):
        victim, vout, high = _wedge(engine, vp, 14, 5, hp, 4)
        engine._admit()
        parked = victim._request
        page_counts.append((engine.metrics["preempted_pages"], engine.allocator.available))
        obs = [engine.metrics["lane_preemptions"],
               engine.slots[0].request is high._request, parked.parked, len(parked.prompt),
               parked.max_tokens, len(engine._fair)]
        hout = []
        _run(engine, [victim, high], [vout, hout])
        obs += [vout, hout, engine.metrics["lane_resumes"], _pool_full(engine)]
        seen.append(obs)
    assert seen[0] == seen[1]
    # free pages after the head's admission: the port's pool gets the
    # victim's 3 pages back, not 4, and the head's 8-token prompt takes 1
    # page, not its chunk window's 2
    (jax_pages, jax_free), (pages, free) = page_counts
    assert (jax_pages, pages, free) == (4.0, 3.0, jax_free)
    (preemptions, high_seated, parked, plen, remaining, queued,
     vout, hout, resumes, full) = seen[1]
    assert (preemptions, resumes, high_seated, parked, queued) == (1.0, 1.0, True, True, 1)
    assert plen == 20 + len(vout[:5]) and remaining == 14 - 5
    assert vout == _greedy(llama, vp, 14) and hout == _greedy(llama, hp, 4) and full


def test_victim_with_a_block_in_flight_is_marked_then_parked(manual, llama):
    """The victim has a decode block in flight when the head arrives: it
    is only marked (dispatch stops feeding it, the head waits), and the
    sweep parks it once the block drains; the stream then resumes exact."""
    vp, hp = _prompt(6, 12), _prompt(7, 8)
    seen = []
    for _, engine in manual(max_slots=1, decode_block_steps=2):
        victim, vout, high = _wedge(engine, vp, 12, 3, hp, 3)
        assert engine._dispatch_decode_block()
        engine._admit()
        lane = engine.snapshot()["lanes"][0]
        obs = [lane["preempt_pending"], lane["blocks_in_flight"], engine.slots[0].decodable,
               engine._dispatch_decode_block(), engine.metrics["lane_preemptions"],
               engine.snapshot()["fair_depths"]]
        _drain(engine)
        engine._admit()
        obs += [engine.metrics["lane_preemptions"], engine.slots[0].request is high._request]
        hout = []
        _run(engine, [victim, high], [vout, hout])
        obs += [vout, hout, _pool_full(engine)]
        seen.append(obs)
    assert seen[0] == seen[1]
    pending, inflight, decodable, dispatched, before, depths, after, seated, vout, hout, full = (
        seen[1])
    assert (pending, inflight, decodable, dispatched, before) == (True, 1, False, False, 0.0)
    assert depths == [{"priority": 1, "tenant": "paid", "depth": 1}]
    assert (after, seated, full) == (1.0, True, True)
    assert vout == _greedy(llama, vp, 12) and hout == _greedy(llama, hp, 3)


def test_page_pressure_preempts_with_a_slot_free(manual, llama):
    """JAX's page-pressure setup: 7 allocatable pages, a 40-token victim
    whose prefill took 6 of them (chunks of 2 pages) and which has emitted
    its first token, a second slot free. The priority-1 admission cannot
    get its 2 pages, so `_reclaim_pages` parks the victim; the victim then
    waits on pages until the head finishes, and both streams end
    token-exact with the pool full again. (Parked later, past 48 tokens,
    the victim's chunk-aligned re-prefill would need 8 pages of the 7:
    ROADMAP.md §C.)"""
    vp, hp = [(i * 7 + 3) % 97 for i in range(40)], [201, 202, 203, 204, 205, 206, 207, 208]
    seen = []
    for _, engine in manual(max_slots=2, decode_block_steps=2, max_inflight_blocks=1,
                            pc=dict(num_pages=8)):
        victim = engine.submit(vp, max_tokens=16, tenant="bulk", priority=0)
        vout = []
        _decode_until(engine, victim, vout, 1)
        obs = [len(vout), engine.allocator.available]
        high = engine.submit(hp, max_tokens=4, tenant="paid", priority=1)
        engine._admit()
        # the head takes the free slot with the parked victim's pages
        obs += [engine.metrics["lane_preemptions"], engine.slots[1].request is high._request,
                engine.slots[0].free]
        hout = []
        _run(engine, [victim, high], [vout, hout])
        obs += [vout, hout, engine.metrics["lane_resumes"], engine.metrics["page_stalls"],
                _pool_full(engine)]
        seen.append(obs)
    assert seen[0] == seen[1]
    emitted, free, preemptions, seated, parked_slot_free, vout, hout, resumes, stalls, full = seen[1]
    assert free == 1 and emitted > 0 and preemptions == 1.0 and seated and parked_slot_free
    assert vout == _greedy(llama, vp, 16) and hout == _greedy(llama, hp, 4)
    assert resumes == 1.0 and stalls >= 1.0 and full


def test_lane_parked_past_a_chunk_boundary_resumes_without_truncation(manual, llama):
    """The setup above with the victim parked past 48 tokens (40 + 9
    emitted): its resumed prompt's last chunk starts at offset 48, page 6.
    JAX grows that chunk to its whole window (pages 6-7: 8 pages of the 7)
    and stalls for good; the port grows
    only to the 7 pages the 49 tokens need, so the victim resumes and ends
    token-exact with its 16 tokens, the head too, and the pool full again."""
    vp, hp = [(i * 7 + 3) % 97 for i in range(40)], [201, 202, 203, 204, 205, 206, 207, 208]
    seen = []
    for name, engine in manual(max_slots=2, decode_block_steps=2, max_inflight_blocks=1,
                               pc=dict(num_pages=8)):
        victim = engine.submit(vp, max_tokens=16, tenant="bulk", priority=0)
        vout = []
        _decode_until(engine, victim, vout, 9)
        high = engine.submit(hp, max_tokens=4, tenant="paid", priority=1)
        engine._admit()
        obs = [engine.metrics["lane_preemptions"], len(victim._request.prompt)]
        hout = []
        if name == "jax":
            for _ in range(100):
                _step(engine)
            ended = [_collect(victim, vout), _collect(high, hout)]
            obs += [ended, engine.metrics["page_stalls"] > 0, engine.metrics["lane_resumes"]]
        else:
            _run(engine, [victim, high], [vout, hout])
            obs += [engine.metrics["lane_resumes"], _pool_full(engine)]
        seen.append(obs + [vout, hout])
    (jpre, jplen, jended, jstalled, jresumes, jvout, jhout), \
        (pre, plen, resumes, full, vout, hout) = seen
    assert (jpre, pre) == (1.0, 1.0) and jplen == plen > 48
    # JAX: the head ends, the victim's re-prefill waits on an 8th page forever
    assert jended == [False, True] and jstalled and jresumes == 1.0 and len(jvout) < 16
    assert jhout == _greedy(llama, hp, 4)
    assert vout == _greedy(llama, vp, 16) and hout == _greedy(llama, hp, 4)
    assert resumes == 1.0 and full


def test_preemption_config_gate(manual, llama):
    """serve_lane_preemption=False: the head waits for the slot; nothing is
    parked."""
    jcfg.set(serve_lane_preemption=False)
    tcfg.set(serve_lane_preemption=False)
    vp, hp = _prompt(8, 8), _prompt(9, 8)
    seen = []
    for _, engine in manual(max_slots=1, decode_block_steps=2):
        victim, vout, high = _wedge(engine, vp, 10, 3, hp, 2)
        engine._admit()
        obs = [engine.slots[0].request is victim._request, engine.slots[0].preempt_pending]
        hout = []
        _run(engine, [victim, high], [vout, hout])
        obs += [vout, hout, engine.metrics["lane_preemptions"]]
        seen.append(obs)
    assert seen[0] == seen[1]
    assert seen[1][:2] == [True, False] and seen[1][4] == 0.0
    assert seen[1][2] == _greedy(llama, vp, 10) and seen[1][3] == _greedy(llama, hp, 2)


def test_preemption_returns_every_ref_to_the_pool(manual):
    """After a preemption round fully drains, every page's refcount is 0
    (the prefix cache off) and the pool is whole: the same refcounts as
    JAX's allocator at every observation."""
    seen = []
    for _, engine in manual(max_slots=1, decode_block_steps=2):
        victim, vout, high = _wedge(engine, [4] * 12, 20, 3, [9] * 12, 4)
        held = list(engine.slots[0].pages)
        obs = [[engine.allocator.refcount(p) for p in held]]
        engine._admit()
        obs += [[engine.allocator.refcount(p) for p in held], engine.allocator.available]
        _run(engine, [victim, high], [vout, []])
        obs += [[engine.allocator.refcount(p) for p in range(engine.paged.num_pages)],
                engine.allocator.available, engine.metrics["lane_preemptions"]]
        seen.append(obs)
    assert seen[0] == seen[1]
    before, after, free_after_park, refs, free, preemptions = seen[1]
    assert set(before) == {1} and (set(after) <= {0, 1}) and preemptions == 1.0
    assert set(refs) == {0} and free == PC["num_pages"] - 1


def test_shared_prefix_pages_survive_a_park(manual, llama):
    """The victim's first pages come from the prefix cache: the park drops
    only its refs (the cache keeps them), the resumed victim re-prefills
    through the cache, and a later request over the warm prompt still
    gets the warm tokens. Same refcounts and hits as JAX's engine."""
    shared = _prompt(10, 16)  # 2 full pages
    vp, hp = shared + _prompt(11, 8), _prompt(12, 8)
    seen = []
    for _, engine in manual(max_slots=1, decode_block_steps=2, pc=dict(prefix_cache=True)):
        warm = engine.submit(shared, max_tokens=4, tenant="warm")
        wout = []
        _run(engine, [warm], [wout])
        victim, vout, high = _wedge(engine, vp, 12, 4, hp, 3)
        shared_pages = list(engine.slots[0].pages[:2])
        obs = [[engine.allocator.refcount(p) for p in shared_pages]]
        engine._admit()
        obs += [[engine.allocator.refcount(p) for p in shared_pages],
                engine.metrics["lane_preemptions"]]
        hout = []
        _run(engine, [victim, high], [vout, hout])
        again = engine.submit(shared, max_tokens=4, tenant="warm2")
        aout = []
        _run(engine, [again], [aout])
        stats = engine.stats()
        obs += [wout, vout, hout, aout, stats["prefix_cache_hits"], _pool_full(engine)]
        seen.append(obs)
    assert seen[0] == seen[1]
    before, after, preemptions, wout, vout, hout, aout, hits, full = seen[1]
    assert before == [2, 2] and after == [1, 1] and preemptions == 1.0
    assert wout == aout == _greedy(llama, shared, 4)
    assert vout == _greedy(llama, vp, 12) and hout == _greedy(llama, hp, 3)
    assert hits >= 4.0 and full


def test_park_waits_for_a_verify_round_in_flight(manual, llama):
    """Speculative mode: the victim's verify round is in flight when the
    head arrives, so it is marked; once the round drains (and rolls back)
    the sweep parks it; the resumed stream is the greedy reference."""
    vp, hp = _prompt(13, 14), _prompt(14, 8)
    seen = []
    for _, engine in manual(max_slots=1, proposer=True):
        victim = engine.submit(vp, max_tokens=10, tenant="bulk")
        vout = []
        _decode_until(engine, victim, vout, 3)
        assert engine._dispatch_spec_verify()
        high = engine.submit(hp, max_tokens=3, tenant="paid", priority=1)
        engine._admit()
        obs = [engine.slots[0].spec_inflight, engine.slots[0].preempt_pending,
               engine.metrics["lane_preemptions"]]
        _drain(engine)
        engine._admit()
        obs += [engine.metrics["lane_preemptions"], engine.slots[0].request is high._request]
        hout = []
        _run(engine, [victim, high], [vout, hout])
        obs += [vout, hout, engine.metrics["lane_resumes"], _pool_full(engine)]
        seen.append(obs)
    assert seen[0] == seen[1]
    assert seen[1][:5] == [True, True, 0.0, 1.0, True]
    assert seen[1][5] == _greedy(llama, vp, 10) and seen[1][6] == _greedy(llama, hp, 3)
    assert seen[1][7] == 1.0 and seen[1][8]


def test_park_waits_for_the_first_token_fetch(manual, llama):
    """The port counts a lane's "first" fetch (speculative mode) as work in
    flight, so a lane whose first token has not drained is marked, not
    parked, and parks only after it; JAX's engine parks it at once and
    drops the late fetch (its retirement does not wait for the fetch)."""
    vp, hp = _prompt(15, 10), _prompt(16, 8)
    (_, jeng), (_, teng) = manual(max_slots=1, proposer=True)
    engine = teng
    victim = engine.submit(vp, max_tokens=6, tenant="bulk")
    engine._admit()
    while engine.slots[0].prefilling:
        assert engine._mixed_tick()
    high = engine.submit(hp, max_tokens=3, tenant="paid", priority=1)
    engine._admit()
    assert engine.slots[0].preempt_pending and engine.slots[0].blocks_in_flight == 1
    assert engine.metrics["lane_preemptions"] == 0.0
    _drain(engine)
    engine._admit()
    assert engine.metrics["lane_preemptions"] == 1.0
    assert engine.slots[0].request is high._request
    vout, hout = [], []
    _run(engine, [victim, high], [vout, hout])
    # the first token was emitted before the park, and the resume re-prefills it
    assert vout == _greedy(llama, vp, 6) and hout == _greedy(llama, hp, 3)
    assert _pool_full(engine)
