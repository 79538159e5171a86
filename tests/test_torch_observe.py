"""Serve's observability plane in ray_tpu_torch's engines against ray_tpu's
on the CPU: the request-forensics marks and spans of both engines, the
engine gauges and the decode block's counted cost, the state queries over
them, and `paged.chunk_prefill_step`.

The drills run llama-tiny at f32 on weights converted from the JAX init,
with every engine's loop patched out: the test drives admission, ticks,
dispatch and drains by hand (`test_torch_overload`'s helpers), so the two
engines take the same steps and each request's phase sequence and mark
arguments must be equal. Attributes that are durations (`*_s`) depend on
the host's clock: the test holds their presence, not their values.
"""

import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core.config import cfg as jcfg
from ray_tpu.serve import reqlog as jreqlog
from ray_tpu.serve import tenancy as jtenancy
from ray_tpu.serve.llm import paged as jpaged
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.core.config import cfg as tcfg
from ray_tpu_torch.serve import reqlog as treqlog
from ray_tpu_torch.serve import tenancy as ttenancy
from ray_tpu_torch.serve.llm import paged as tpaged
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import profiling as tprofiling
from ray_tpu_torch.util import state as tstate
from ray_tpu_torch.util import tracing as ttracing
from tests.test_torch_overload import (  # noqa: F401 - fixtures
    SHEDS,
    TIMEOUTS,
    _collect,
    _decode_until,
    _prompt,
    _run,
    llama,
    manual,
    manual_dense,
)

REQLOGS = {"jax": jreqlog, "torch": treqlog}
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _clean():
    for m in (jreqlog, treqlog):
        m.log().clear()
    for m in (jtenancy, ttenancy):
        m.reset()
    for m in (jmetrics, tmetrics):
        m.registry().clear()
    for m in (jtracing, ttracing):
        m.tracer().clear()
    yield
    for m in (jreqlog, treqlog):
        m.log().clear()
    for m in (jtenancy, ttenancy):
        m.reset()
    jcfg.reset()
    tcfg.reset()


def _marks(name, request_id):
    """(phase, tenant, attrs without durations) of one request, and the
    names of its duration attributes, in mark order."""
    out = []
    for m in REQLOGS[name].log().timeline(request_id):
        attrs = m.get("attrs", {})
        out.append((m["phase"], m.get("tenant"),
                    {k: v for k, v in attrs.items() if not k.endswith("_s")},
                    sorted(k for k in attrs if k.endswith("_s"))))
    return out


def _phases(marks):
    return [m[0] for m in marks]


def _drive_paged(pairs, drill):
    """Run `drill(name, engine)` on each engine; returns each engine's
    observations."""
    return [drill(name, engine) for name, engine in pairs]


# ------------------------------------------------------------ paged drills


def test_paged_plain_request_marks_match_jax(manual):
    """A plain request: submitted, admitted, one mark per prompt chunk, the
    decode blocks at dispatch (the first carries the first token in its
    row 0), first_token and finished at emission."""
    prompt = _prompt(11, 21)

    def drill(name, engine):
        stream = engine.submit(prompt, max_tokens=7, tenant="acme", request_id="r-plain")
        out = []
        _run(engine, [stream], [out])
        return out, _marks(name, "r-plain")

    seen = _drive_paged(manual(max_slots=2, decode_block_steps=2), drill)
    assert seen[0] == seen[1]
    out, marks = seen[1]
    assert len(out) == 7
    phases = _phases(marks)
    assert phases[:2] == ["engine.submitted", "engine.admitted"]
    assert phases.count("engine.prefill_chunk") == 2  # 21 tokens in chunks of 16
    assert phases[-1] == "engine.finished" and phases.count("engine.first_token") == 1
    assert phases.index("engine.decode_block") < phases.index("engine.first_token")
    chunks = [m[2] for m in marks if m[0] == "engine.prefill_chunk"]
    assert chunks == [{"offset": 0, "tokens": 16}, {"offset": 16, "tokens": 5}]
    assert sum(m[2]["steps"] for m in marks if m[0] == "engine.decode_block") == 6
    assert marks[0][2] == {"prompt_tokens": 21, "max_tokens": 7}
    first = next(m for m in marks if m[0] == "engine.first_token")
    assert first[3] == ["cache_saved_s", "preempt_wait_s", "prefill_compute_s",
                        "queue_wait_s", "ttft_s"]
    assert all(m[1] == "acme" for m in marks)


def test_paged_prefix_hit_marks_match_jax(manual):
    """The second request over a warmed prefix records the hit at
    admission (hit_pages, cached_tokens) and cached_tokens at first token."""
    shared = _prompt(12, 16)  # two full pages

    def drill(name, engine):
        warm = engine.submit(list(shared), max_tokens=2, tenant="warm", request_id="r-warm")
        _run(engine, [warm], [[]])
        hit = engine.submit(list(shared) + [7, 14, 21], max_tokens=3, tenant="hit",
                            request_id="r-hit")
        _run(engine, [hit], [[]])
        return _marks(name, "r-warm"), _marks(name, "r-hit")

    seen = _drive_paged(manual(max_slots=2, decode_block_steps=2,
                               pc=dict(prefix_cache=True)), drill)
    assert seen[0] == seen[1]
    _, hit = seen[1]
    admitted = next(m for m in hit if m[0] == "engine.admitted")
    assert admitted[2]["hit_pages"] == 2 and admitted[2]["cached_tokens"] == 16
    first = next(m for m in hit if m[0] == "engine.first_token")
    assert first[2] == {"cached_tokens": 16}


def test_paged_spec_rollback_marks_match_jax(manual):
    """Speculative rounds with a proposer that is nearly always wrong:
    spec_round marks with proposed / accepted / rollback_pages, equal to
    JAX's round by round."""
    prompt = _prompt(13, 6)

    def drill(name, engine):
        stream = engine.submit(prompt, max_tokens=10, request_id="r-spec")
        out = []
        _run(engine, [stream], [out])
        return out, _marks(name, "r-spec")

    seen = _drive_paged(manual(max_slots=1, proposer=True), drill)
    assert seen[0] == seen[1]
    out, marks = seen[1]
    rounds = [m[2] for m in marks if m[0] == "engine.spec_round"]
    assert rounds and all(r["accepted"] <= r["proposed"] for r in rounds)
    assert any(r["accepted"] < r["proposed"] for r in rounds)
    assert "engine.decode_block" not in _phases(marks)


def _preempted(marks):
    """The arguments of a request's engine.preempted mark."""
    return next(m for m in marks if m[0] == "engine.preempted")[2]


def test_paged_preempt_and_resume_marks_match_jax(manual):
    """One slot: a priority-1 request parks the decoding lane (preempted,
    with its pages and generated count), then the victim resumes; the
    events serve.lane_preempted / serve.lane_resumed are emitted."""
    from ray_tpu.util.events import events as jevents
    from ray_tpu_torch.util.events import events as tevents

    vp, hp = _prompt(14, 20), _prompt(15, 8)
    logs = {"jax": jevents, "torch": tevents}

    def drill(name, engine):
        t0 = time.time()
        victim = engine.submit(vp, max_tokens=10, tenant="bulk", priority=0,
                               request_id="r-victim")
        vout = []
        _decode_until(engine, victim, vout, 3)
        high = engine.submit(hp, max_tokens=3, tenant="paid", priority=1, request_id="r-high")
        _run(engine, [victim, high], [vout, []])
        kinds = [e["kind"] for e in logs[name]().list(since_ts=t0, limit=100)
                 if e["kind"].startswith("serve.lane_")]
        return _marks(name, "r-victim"), _marks(name, "r-high"), kinds

    seen = _drive_paged(manual(max_slots=1, decode_block_steps=2), drill)
    # the parked page count differs by rule: JAX grows the prompt's second
    # chunk (offset 16) to its whole page window (4 pages), the port only to
    # the pages the 20-token prompt needs (3), where the 3 decoded
    # positions also fit
    pages = [_preempted(s[0]).pop("pages") for s in seen]
    assert pages == [4, 3]
    assert seen[0] == seen[1]
    victim, high, kinds = seen[1]
    phases = _phases(victim)
    assert phases.index("engine.preempted") < phases.index("engine.resumed") < len(phases) - 1
    assert _preempted(victim) == {"lane": 0, "generated": 3}
    assert kinds == ["serve.lane_preempted", "serve.lane_resumed"]
    assert _phases(high)[-1] == "engine.finished"


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_shed_marks_match_jax(manual, manual_dense, kind):
    """A quota shed and a queue-bound shed each leave one terminal
    engine.shed mark (reason, backlog); the tenant counters and the
    rate-limited serve.shed event match JAX's."""
    from ray_tpu.util.events import events as jevents
    from ray_tpu_torch.util.events import events as tevents

    pairs = manual(max_slots=1, max_queued_requests=2) if kind == "paged" else manual_dense
    seen = []
    for (name, engine), tenancy, metrics, evlog in zip(
            pairs, (jtenancy, ttenancy), (jmetrics, tmetrics), (jevents, tevents)):
        if kind == "dense":
            engine.config.max_queued_requests = 2
        t0 = time.time()
        tenancy.set_tenant("free", quota_rps=0.1, quota_burst=1.0)
        engine.submit([3, 1, 4], max_tokens=2, tenant="free", request_id="r-ok")
        with pytest.raises(SHEDS[name]):
            engine.submit([3, 1, 4], max_tokens=2, tenant="free", request_id="r-quota")
        engine.submit([2, 7, 1], max_tokens=2, tenant="other", request_id="r-other")
        with pytest.raises(SHEDS[name]):
            engine.submit([2, 7, 1], max_tokens=2, tenant="other", request_id="r-full")
        counters = {
            metric: sorted((tags["tenant"], v) for tags, v in metrics.registry().get(metric).collect())
            for metric in ("raytpu_serve_tenant_shed_total", "raytpu_serve_tenant_requests_total")
        }
        sheds = [e["extra"]["tenant"] for e in evlog().list(kind="serve.shed", since_ts=t0)]
        seen.append((_marks(name, "r-quota"), _marks(name, "r-full"), counters, sheds))
    assert seen[0] == seen[1]
    quota, full, counters, sheds = seen[1]
    assert [m[:3] for m in quota] == [("engine.shed", "free", {"reason": "quota"})]
    assert quota[0][3] == ["retry_after_s"]
    assert [m[:3] for m in full] == [("engine.shed", "other",
                                      {"reason": "queue_full", "backlog": 2})]
    assert counters["raytpu_serve_tenant_shed_total"] == [("free", 1.0), ("other", 1.0)]
    assert counters["raytpu_serve_tenant_requests_total"] == [("free", 1.0), ("other", 1.0)]
    assert sheds == ["free", "other"]


def test_paged_timeout_marks_match_jax(manual):
    """Expired before submit, at the admit pop, and mid-decode: each exit
    leaves one terminal engine.timeout mark (reason or generated)."""
    def drill(name, engine):
        with pytest.raises(TIMEOUTS[name]):
            engine.submit([1, 2, 3], max_tokens=2, deadline_ts=time.time() - 1.0,
                          request_id="r-late")
        doomed = engine.submit([4, 5, 6], max_tokens=4, deadline_ts=time.time() + 0.05,
                               request_id="r-doomed")
        time.sleep(0.1)
        engine._admit()
        with pytest.raises(TIMEOUTS[name]):
            doomed.result(timeout=10)
        stream = engine.submit(_prompt(16, 13), max_tokens=20, deadline_ts=time.time() + 600,
                               request_id="r-mid")
        out = []
        _decode_until(engine, stream, out, 5)
        engine.slots[0].request.deadline_ts = time.time() - 1.0
        _run(engine, [stream], [out])
        return [_marks(name, r) for r in ("r-late", "r-doomed", "r-mid")], out

    seen = _drive_paged(manual(max_slots=1, decode_block_steps=2), drill)
    assert seen[0] == seen[1]
    (late, doomed, mid), out = seen[1]
    assert late == [("engine.timeout", "default", {"reason": "expired_before_submit"}, [])]
    assert _phases(doomed) == ["engine.submitted", "engine.timeout"]
    assert doomed[-1][2] == {"generated": 0}
    assert mid[-1][:3] == ("engine.timeout", "default", {"generated": len(out) - 1})
    assert "engine.finished" not in _phases(mid)


# ------------------------------------------------------------ dense drills


def test_dense_plain_and_timeout_marks_match_jax(manual_dense):
    """The dense engine: submitted, admitted, first_token (at its prefill),
    finished; a deadline mid-decode ends in engine.timeout. Its
    engine.request / engine.prefill spans carry JAX's attributes."""
    seen = []
    for (name, engine), tracer in zip(manual_dense, (jtracing, ttracing)):
        stream = engine.submit(_prompt(17, 9), max_tokens=4, tenant="acme",
                               request_id="r-dense")
        engine._admit()
        for _ in range(3):
            engine._decode_round()
        out = []
        assert _collect(stream, out)
        doomed = engine.submit(_prompt(18, 9), max_tokens=20, deadline_ts=time.time() + 600,
                               request_id="r-dense-mid")
        engine._admit()
        engine._decode_round()
        engine.slots[0].request.deadline_ts = time.time() - 1.0
        engine._deadline_sweep()
        spans = {s["name"]: s for s in tracer.tracer().spans()
                 if s["attrs"].get("request_id") == "r-dense" or s["name"] == "engine.prefill"}
        request_span = spans["engine.request"]
        seen.append((out, _marks(name, "r-dense"), _marks(name, "r-dense-mid"),
                     sorted(request_span["attrs"]), request_span["status"],
                     sorted(spans["engine.prefill"]["attrs"])))
        assert doomed._request.span is None
    assert seen[0] == seen[1]
    _, marks, mid, span_attrs, status, prefill_attrs = seen[1]
    assert _phases(marks) == ["engine.submitted", "engine.admitted", "engine.first_token",
                              "engine.finished"]
    assert marks[1][2] == {"lane": 0} and marks[-1][2] == {"generated": 4}
    assert _phases(mid)[-1] == "engine.timeout" and mid[-1][2] == {"generated": 2}
    assert {"ttft_s", "tpot_s", "queue_s", "request_id"} <= set(span_attrs) and status == "OK"
    assert "bucket" in prefill_attrs


# ------------------------------------------------------- gauges and cost


def test_engine_gauges_and_histograms_carry_the_run(manual):
    """The engine registry's callback gauges (batch_fill, tick_seconds,
    decode_mfu, token_mix) and the per-tenant TTFT histograms come out of
    /metrics under JAX's names and labels; token_mix equals JAX's."""
    pairs = manual(max_slots=2, decode_block_steps=2)
    seen = []
    for (name, engine), metrics in zip(pairs, (jmetrics, tmetrics)):
        streams = [engine.submit(_prompt(19 + i, 10), max_tokens=5, tenant="acme")
                   for i in range(2)]
        _run(engine, streams, [[], []])
        engine.metrics["batch_fill"] = 0.5  # the loop sets it; it is patched out
        from importlib import import_module
        eng_mod = import_module(("ray_tpu" if name == "jax" else "ray_tpu_torch")
                                + ".serve.llm.engine")
        eng_mod._observe_tick(engine, 0.25)
        text = metrics.registry().prometheus_text()
        label = engine.metrics_label
        mix = sorted((tags["phase"], v) for tags, v in
                     metrics.registry().get("raytpu_engine_token_mix").collect()
                     if tags["engine"] == label)
        hists = sorted(n for n in ("raytpu_serve_ttft_queue_wait_seconds",
                                   "raytpu_serve_ttft_preempt_wait_seconds",
                                   "raytpu_serve_ttft_prefill_compute_seconds")
                       if f'{n}_count{{tenant="acme"}} 2' in text)
        seen.append((mix, hists, engine.metrics["tick_seconds"],
                     f'raytpu_engine_batch_fill{{engine="{label}"}} 0.5' in text,
                     f'raytpu_engine_tick_seconds{{engine="{label}"}}' in text,
                     f'raytpu_engine_decode_mfu{{engine="{label}"}}' in text))
    assert seen[0][:2] == seen[1][:2]
    mix, hists, tick, *present = seen[1]
    assert mix == [("decode", 8.0), ("prefill", 20.0)] and len(hists) == 3
    assert all(present) and tick > 0
    engine = pairs[1][1]
    assert engine.metrics["decode_mfu"] > 0 and engine.metrics["decode_flops"] > 0


def _products_flops(config, rows):
    """2 x rows x the weights every decode step multiplies: the layers'
    attention and MLP projections and the LM head."""
    e, f, v = config.d_model, config.d_ff, config.vocab_size
    hd = config.head_dim
    attn = e * config.n_heads * hd * 2 + e * config.kv_heads * hd * 2
    mlp = e * f * (3 if config.act == "swiglu" else 2)
    return 2.0 * rows * (config.n_layers * (attn + mlp) + e * v)


def test_decode_block_cost_equals_the_closed_form(manual, llama):
    """step_cost of the paged engine's K-step decode block, counted on
    meta tensors at its fixed shapes, equals the closed form: the
    products' 2 x weights x rows per step plus K5's formula (two products
    of 2 x D FLOPs per q row and kv position: every region row of the
    decode call against its table's pages x page size) per layer."""
    _, _, tconfig, _ = llama
    (_, jengine), (_, engine) = manual(max_slots=2, decode_block_steps=3)
    stream = engine.submit(_prompt(20, 9), max_tokens=6)
    _run(engine, [stream], [[]])
    cost = engine._tick_cost
    assert cost, "the first plain decode dispatch did not price the block"
    ms, k = 2, 3
    pc = engine.paged
    kv_span = pc.max_pages_per_slot * pc.page_size
    ragged = 4.0 * tconfig.n_heads * (ms * 8) * kv_span * tconfig.head_dim
    closed = k * (_products_flops(tconfig, ms) + tconfig.n_layers * ragged)
    assert cost.flops == pytest.approx(closed, rel=1e-9)
    assert cost.buckets["flops ray_tpu_torch.ragged_paged_attention"] == pytest.approx(
        k * tconfig.n_layers * ragged)
    assert cost.estimated_peaks  # priced on the CPU: no hardware claim
    roof = tprofiling.roofline(cost, 0.1)
    assert roof["mfu"] == pytest.approx(cost.flops / (0.1 * cost.peak_flops))


def test_ragged_custom_op_fake_and_flops_on_meta():
    """K5's entry is a custom op: on meta tensors its fake runs (no
    launch) and the cost count sees the op with its flop formula; on CPU
    tensors it takes the plain version."""
    from torch.utils.flop_counter import FlopCounterMode

    from ray_tpu_torch.ops.ragged_paged_attention import (
        LAUNCHES_BY_KIND, RAGGED, ragged_paged_attention)

    hq, hkv, d, ps, pages, s_count, maxp, bq = 4, 2, 16, 8, 6, 2, 3, 4
    shapes = dict(q=(hq, s_count * bq, d), k=(hkv, pages, ps, d))
    before = (RAGGED.launches, dict(LAUNCHES_BY_KIND))
    for device in ("meta", "cpu"):
        g = torch.Generator().manual_seed(0)
        q = torch.randn(shapes["q"], generator=g).to(device)
        kp = torch.randn(shapes["k"], generator=g).to(device)
        vp = torch.randn(shapes["k"], generator=g).to(device)
        i32 = dict(dtype=torch.int32, device=device)
        args = (torch.arange(s_count, **i32), torch.ones(s_count, **i32),
                torch.tensor([1, 3], **i32), torch.tensor([5, 9], **i32),
                torch.tensor([[1, 0, 0], [2, 3, 0]], **i32))
        with FlopCounterMode(display=False) as counter:
            out = ragged_paged_attention(q, kp, vp, *args, block_q=bq, max_q_blocks=1)
        assert out.shape == shapes["q"] and out.device.type == device
        assert counter.get_total_flops() == 4 * hq * s_count * bq * maxp * ps * d
    assert (RAGGED.launches, dict(LAUNCHES_BY_KIND)) == before


# ----------------------------------------------------------- state queries


def test_state_request_views_and_engine_snapshot(manual):
    """state.request_timeline / list_requests read the request log; the
    waterfall renders; engine_snapshot finds the engine through the
    registry, busy while a request runs and free after."""
    (_, _), (_, engine) = manual(max_slots=2, decode_block_steps=2)
    stream = engine.submit(_prompt(21, 12), max_tokens=5, tenant="snap", request_id="r-snap")
    engine._admit()
    busy = tstate.engine_snapshot()[engine.metrics_label]
    assert [lane["request_id"] for lane in busy["lanes"] if not lane["free"]] == ["r-snap"]
    assert busy["pages"]["in_use"] > 0
    _run(engine, [stream], [[]])
    idle = tstate.engine_snapshot()[engine.metrics_label]
    assert all(lane["free"] for lane in idle["lanes"])
    assert idle["pages"]["free"] == idle["pages"]["total"]
    timeline = tstate.request_timeline("r-snap")
    assert [m["phase"] for m in timeline] == [m["phase"] for m in treqlog.log().timeline("r-snap")]
    assert all(a["ts"] <= b["ts"] for a, b in zip(timeline, timeline[1:]))
    (summary,) = tstate.list_requests(tenant="snap")
    assert summary["request_id"] == "r-snap" and summary["terminal"] == "engine.finished"
    text = treqlog.render_waterfall(timeline)
    assert "TTFT" in text and "terminal: engine.finished" in text


# ---------------------------------------------------------- chunk prefill


def test_chunk_prefill_step_matches_jax(llama):
    """The one-slot chunk prefill: logits and the pool equal JAX's at TOL,
    and equal batched_chunk_prefill_step at B 1."""
    jconfig, jparams, tconfig, tparams = llama
    pc = dict(page_size=8, num_pages=16, max_pages_per_slot=4, chunk_pages=2)
    jcache = jpaged.init_paged_cache(jconfig, jpaged.PagedConfig(**pc))
    tcache = tpaged.init_paged_cache(tconfig, tpaged.PagedConfig(**pc), device="cpu")
    rng = np.random.default_rng(3)
    row = np.array([3, 5, 0, 0], dtype=np.int32)
    chunk_ids = np.array([3, 5], dtype=np.int32)
    tokens = np.zeros((1, 16), dtype=np.int32)
    tokens[0, :11] = rng.integers(1, 200, 11)
    jlogits, jcache = jpaged.chunk_prefill_step(
        jparams, jcache, jnp.asarray(row), jnp.asarray(chunk_ids), jnp.asarray(tokens),
        jnp.asarray(0, jnp.int32), jnp.asarray(11, jnp.int32), jconfig, page_size=8)
    tlogits, tcache = tpaged.chunk_prefill_step(
        tparams, tcache, torch.from_numpy(row), torch.from_numpy(chunk_ids).long(),
        torch.from_numpy(tokens).long(), torch.tensor(0), torch.tensor(11), tconfig,
        page_size=8)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)
    bcache = tpaged.init_paged_cache(tconfig, tpaged.PagedConfig(**pc), device="cpu")
    blogits, bcache = tpaged.batched_chunk_prefill_step(
        tparams, bcache, torch.from_numpy(row)[None], torch.from_numpy(chunk_ids).long()[None],
        torch.from_numpy(tokens).long(), torch.tensor([0]), torch.tensor([11]), tconfig,
        page_size=8)
    assert torch.equal(blogits, tlogits) and torch.equal(bcache["k"], tcache["k"])
    assert math.isfinite(float(tlogits.abs().max()))
