"""The frozen counts (`benchmark/counts/`) against hand-worked small cases
and against the bounds PERF.md's kernel table gives at two of its shapes
(K5's mixed and decode batches of the Llama-3-8B check, K1 / K2 at GPT-2
small's train step): bytes and operations from shapes alone, bound = the
larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s."""

import math

import pytest

from benchmark.counts import attention, model
from benchmark.counts.peaks import H100_SXM, bound_s


def test_ragged_lane_by_hand():
    # one decode lane: 1 query at position 99 (100 keys), 2 q heads over 1
    # kv head, D 4, pages of 16: 7 pages of K and V
    flops, nbytes = attention.ragged_lane(1, 100, hq=2, hkv=1, d=4, page_size=16, itemsize=2)
    assert flops == 4.0 * 2 * 4 * 100
    assert nbytes == 2 * 1 * 2 * 4 * 2 + 2 * 7 * 1 * 16 * 4 * 2
    # a chunk of 3 queries ending at 10 keys: keys 8 + 9 + 10
    flops, _ = attention.ragged_lane(3, 10, hq=1, hkv=1, d=1, page_size=16)
    assert flops == 4.0 * 27


def test_ragged_call_is_its_lanes_plus_descriptors_and_padding():
    q_lens, kv_lens, counts = [5, 1], [70, 33], [1, 1]
    kw = dict(hq=4, hkv=2, d=8, page_size=16)
    f, b = attention.ragged_call(q_lens, kv_lens, counts, block_q=8, max_pages=8, **kw)
    lanes = [attention.ragged_lane(q, k, **kw) for q, k in zip(q_lens, kv_lens)]
    assert f == sum(x[0] for x in lanes)
    padding = (sum(counts) * 8 - sum(q_lens)) * 4 * 8 * 2
    desc = 4 * 2 * 4 + 2 * 8 * 4
    assert b == sum(x[1] for x in lanes) + padding + desc


def _ms(cost):
    return 1e3 * bound_s(*cost, H100_SXM)


@pytest.mark.parametrize("case, expected_ms", [
    # PERF.md, K5 "Bound ms": the mixed tick's batch and a decode step's
    ("mixed", 0.0077), ("decode", 0.0053)])
def test_ragged_bound_at_perf_md_shapes(case, expected_ms):
    if case == "mixed":
        q_lens, kv_lens = [256, 256, 100, 1, 1, 1, 4, 0], [256, 512, 612, 301, 901, 64, 704, 0]
        counts = [32, 32, 32, 1, 1, 1, 1, 1]
    else:
        q_lens, kv_lens = [1] * 8, [80, 199, 318, 438, 557, 677, 796, 916]
        counts = [1] * 8
    cost = attention.ragged_call(q_lens, kv_lens, counts, block_q=8, max_pages=16, hq=32,
                                 hkv=8, d=128, page_size=64)
    assert cost[1] / H100_SXM["hbm_bytes_per_s"] > cost[0] / H100_SXM["bf16_flops"]
    assert round(_ms(cost), 4) == expected_ms


def test_flash_bounds_at_perf_md_shapes():
    # PERF.md: K1 at GPT-2's train shape 0.0151 ms, K2 dkv 0.0261, dq 0.0196
    shape = (8, 12, 12, 1024, 64)
    assert round(_ms(attention.flash_fwd(*shape)), 4) == 0.0151
    bwd = attention.flash_bwd(*shape)
    assert round(_ms(bwd["dkv"]), 4) == 0.0261
    assert round(_ms(bwd["dq"]), 4) == 0.0196
    # the Llama check's shape is bound by its operations: 0.0072
    assert round(_ms(attention.flash_fwd(1, 32, 8, 931, 128)), 4) == 0.0072


def test_flash_fwd_by_hand():
    flops, nbytes = attention.flash_fwd(1, 2, 1, 3, 4, itemsize=2)
    assert flops == 4.0 * 1 * 2 * 4 * 6  # 6 causal pairs
    assert nbytes == 2 * (2 * 3 * 4 * 2) + 2 * (1 * 3 * 4 * 2) + 2 * 3 * 4


CFG = {"model": {"d_model": 8, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1, "d_ff": 16,
                 "vocab_size": 10, "act": "swiglu"},
       "engine": {"page_size": 4}}


def test_model_flops_by_hand():
    # per layer q 8x8, k 8x4, v 8x4, o 8x8, MLP 3 x 8x16; head 8x10
    assert model.matmul_params(CFG) == 2 * (64 + 32 + 32 + 64 + 3 * 128) + 80
    n = model.matmul_params(CFG)
    assert model.token_flops(CFG, 4) == 2.0 * n + 4.0 * 2 * 2 * 4 * 5
    assert model.train_step_flops(CFG, 3, 5) == 6.0 * n * 15 + 12.0 * 2 * 2 * 4 * 3 * 15


def test_serve_work_adds_up():
    w = model.serve_work(CFG, prompt_len=10, cached=4, decode_positions=[10, 11], chunk=4,
                         prefill=True)
    assert [c for c in model.prefill_chunks(10, 4, 4)] == [(4, 8), (2, 10)]
    by_token = sum(model.token_flops(CFG, p) for p in list(range(4, 10)) + [10, 11])
    assert math.isclose(w["model_flops"], by_token)
    f1, _ = attention.ragged_lane(1, 11, hq=2, hkv=1, d=4, page_size=4)
    f2, _ = attention.ragged_lane(1, 12, hq=2, hkv=1, d=4, page_size=4)
    assert w["k5_decode_flops"] == 2 * (f1 + f2)
