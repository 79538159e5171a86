"""The paged engine's pipelined dispatch on the CPU (ray_tpu_torch only).

The passes run eagerly here; the pipeline around them is the card's: the
token vector stays on the engine's device, each pass's tokens go out as a
fetch entry that a drain thread reads, and up to max_inflight_blocks
blocks are dispatched before the loop waits. A slowed drain (each read
sleeps first) makes dispatch run ahead of emission, so lanes end, stall
and shut down with blocks in flight. Tokens are held against the greedy
argmax of the dense forward, computed token by token.
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import models as tmodels
from ray_tpu_torch.serve.llm import PagedConfig, PagedEngineConfig, PagedLLMEngine
from ray_tpu_torch.serve.llm import paged_engine

PC = dict(page_size=8, num_pages=64, max_pages_per_slot=8, chunk_pages=2)


@pytest.fixture(scope="module")
def model():
    config = tmodels.get_config("llama-tiny")
    return config, tmodels.init_params(config, 0, device="cpu")


def _dense_greedy(model, prompt, n):
    config, params = model
    tokens = list(prompt)
    for _ in range(n):
        logits = tmodels.forward(params, torch.tensor([tokens]), config)
        tokens.append(int(torch.argmax(logits[0, -1])))
    return tokens[len(prompt):]


def _engine(model, paged=None, **engine_kw):
    config, params = model
    return PagedLLMEngine(config, params, PagedEngineConfig(
        paged=PagedConfig(**(paged or PC)), **engine_kw), device="cpu")


@pytest.fixture
def slow_drain(monkeypatch):
    """Each device read waits 20 ms first: dispatch runs ahead of emission."""
    read = paged_engine._Fetch.values

    def values(self):
        time.sleep(0.02)
        return read(self)

    monkeypatch.setattr(paged_engine._Fetch, "values", values)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 200, size=n)]


def test_max_tokens_one_takes_the_first_fetch(model):
    """A lane with max_tokens=1 has no block to carry its first token: it
    takes a "first" fetch of its own, and retires only after it drains."""
    prompt = _prompt(1, 19)
    engine = _engine(model, max_slots=2)
    kinds = []
    put = engine._fetchq.put
    engine._fetchq.put = lambda item: (kinds.append(item and item[0]), put(item))
    try:
        got = engine.generate(prompt, max_tokens=1)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert got == _dense_greedy(model, prompt, 1)
    assert kinds[0] == "first" and "block" not in kinds
    assert stats["decode_blocks"] == 0 and stats["pages_free"] == PC["num_pages"] - 1


def test_stops_end_lanes_with_blocks_in_flight(model, slow_drain):
    """Stop ids and stop sequences end streams at the right token while
    later blocks of theirs are already dispatched; every page comes back."""
    prompt = _prompt(2, 21)
    expected = _dense_greedy(model, prompt, 12)
    engine = _engine(model, max_slots=4, decode_block_steps=2)
    in_flight_at_retire = []
    finish = engine._finish

    def recording_finish(idx, slot):
        in_flight_at_retire.append(slot.blocks_in_flight)
        finish(idx, slot)

    engine._finish = recording_finish
    try:
        stop_id = engine.submit(prompt, max_tokens=12, stop_token_ids=[expected[3]])
        stop_seq = engine.submit(prompt, max_tokens=12, stop_sequences=[expected[2:5]])
        full = engine.submit(prompt, max_tokens=12)
        assert stop_id.result(timeout=120) == expected[: expected.index(expected[3]) + 1]
        assert stop_seq.result(timeout=120) == expected[:5]
        assert full.result(timeout=120) == expected
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert stats["pages_free"] == PC["num_pages"] - 1
    assert max(in_flight_at_retire) > 0


@pytest.mark.parametrize("max_inflight_blocks", [1, 8])
def test_page_backpressure_with_blocks_in_flight(model, slow_drain, max_inflight_blocks):
    """More demand than pages while blocks are in flight: admissions and
    decode growth wait on the allocator, every request ends with the dense
    greedy tokens, and every page comes back."""
    prompts = [_prompt(10 + i, 5) for i in range(6)]
    engine = _engine(model, dict(page_size=8, num_pages=7, max_pages_per_slot=4, chunk_pages=1),
                     max_slots=4, decode_block_steps=2, max_inflight_blocks=max_inflight_blocks)
    try:
        outs = [s.result(timeout=120) for s in [engine.submit(p, max_tokens=6) for p in prompts]]
        stats = engine.stats()
    finally:
        engine.shutdown()
    for prompt, got in zip(prompts, outs):
        assert got == _dense_greedy(model, prompt, 6), prompt
    assert stats["page_stalls"] > 0 and stats["pages_free"] == 6


def test_drain_error_fails_every_open_request(model, monkeypatch):
    """A device read that raises in the drain thread reaches the loop,
    which fails every open and queued request with it; a later submit
    raises, and shutdown stops both threads."""

    def broken(self):
        raise RuntimeError("device read failed")

    monkeypatch.setattr(paged_engine._Fetch, "values", broken)
    engine = _engine(model, max_slots=2)
    try:
        streams = [engine.submit(_prompt(20 + i, 9), max_tokens=8) for i in range(4)]
        for stream in streams:
            with pytest.raises(RuntimeError, match="device read failed"):
                stream.result(timeout=60)
        with pytest.raises(RuntimeError, match="engine is dead"):
            engine.submit([1, 2, 3], max_tokens=2)
    finally:
        engine.shutdown(timeout=30)
    assert not engine._thread.is_alive() and not engine._drainer.is_alive()


def test_shutdown_with_blocks_in_flight(model, monkeypatch):
    """shutdown stops the loop and the drain thread while blocks are still
    in flight."""
    read = paged_engine._Fetch.values

    def slow(self):
        time.sleep(0.2)
        return read(self)

    monkeypatch.setattr(paged_engine._Fetch, "values", slow)
    engine = _engine(model, max_slots=4, decode_block_steps=2, max_inflight_blocks=4)
    for i in range(4):
        engine.submit(_prompt(30 + i, 7), max_tokens=40)
    deadline = time.monotonic() + 60
    while engine.stats()["inflight_blocks"] < 2:
        assert time.monotonic() < deadline, "no blocks went in flight"
        time.sleep(0.01)
    engine.shutdown(timeout=30)
    assert not engine._thread.is_alive() and not engine._drainer.is_alive()


def test_stats_count_passes_and_launches(model):
    """stats() reports the ticks and blocks, each pass's runs (eager here)
    and, per kernel, runs x the launches its capture recorded: none on the
    CPU, where nothing is captured."""
    engine = _engine(model, max_slots=4, decode_block_steps=4)
    try:
        outs = [s.result(timeout=120) for s in
                [engine.submit(_prompt(40 + i, 9 + 11 * i), max_tokens=9) for i in range(3)]]
        stats = engine.stats()
        assert all(len(o) == 9 for o in outs)
        mixed = sum(stats[f"passes.mixed.{b}"] for b in (1, 2, 4))
        blocks = stats["passes.decode.plain"] + stats["passes.decode.filtered"]
        assert mixed == stats["mixed_ticks"] > 0 and blocks > 0
        # decode steps: K per block, plus one per mixed tick's ride-along
        assert stats["decode_steps"] == 4 * blocks + (stats["decode_blocks"] - blocks)
        assert not any(key.startswith("launches.") for key in stats)
        engine._decode["plain"].captured = {"ragged_paged_attention": 8, "ragged.decode": 8}
        stats = engine.stats()
        assert stats["launches.ragged_paged_attention"] == 8 * stats["passes.decode.plain"]
    finally:
        engine.shutdown()
