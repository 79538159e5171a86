"""ray_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc: it is marked `cuda` and
skips elsewhere. Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

This file imports no JAX (`--noconftest` skips tests/conftest.py, which
does), so it runs where only PyTorch is installed.

Tolerances: bf16 atol = rtol = 2e-2 (both sides compute in f32 from the
same bf16 inputs; a different summation order can move the final bf16
rounding by one ulp), f32 atol = rtol = 1e-4 (f32 sums in another order).
The train step on the card against the CPU step, f32 with TF32 off:
gradients, losses and grad norms at atol = rtol = 1e-4; parameters after
three steps at atol 1e-3, a tenth of the learning rate, because Adam
divides each element's gradient by its own RMS: an element whose
gradient is near zero moves by up to lr whatever its size, and f32 sums
in another order change that step.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch import ops
from ray_tpu_torch.models import TransformerConfig, init_params
from ray_tpu_torch.ops.attention import _flash_bwd_cuda, _flash_bwd_plain, _flash_fwd_plain
from ray_tpu_torch.ops.ragged_paged_attention import _ragged_cuda, _split_plan
from ray_tpu_torch.serve.llm import PagedConfig, PagedEngineConfig, PagedLLMEngine
from ray_tpu_torch.train import (
    create_train_state,
    default_optimizer,
    loss_and_grads,
    make_train_step,
    tree_leaves,
)

TOLS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _ragged_inputs(dtype, d, seed=0):
    """A small mixed batch: two prefill regions, decode lanes, a verify
    region (q_len 4) and an inactive lane, GQA 8/2."""
    inputs = _ragged_batch(dtype, d, 4, [64, 40, 1, 1, 4, 0], [64, 168, 65, 300, 130, 0],
                           [8, 8, 1, 1, 1, 1], seed=seed)
    return (*inputs, dict(block_q=8, max_q_blocks=8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
def test_ragged_kernel_matches_plain(cuda, dtype, d):
    q, kp, vp, desc, kw = _ragged_inputs(dtype, d)
    before = ops.RAGGED.launches
    out = ops.ragged_paged_attention(q, kp, vp, *desc, **kw)
    assert ops.RAGGED.launches == before + 1
    q_scaled = (q.float() / np.sqrt(d)).to(dtype)
    ref = ops.ragged_reference_attention(q_scaled, kp, vp, *desc, **kw)
    torch.cuda.synchronize()
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _ragged_batch(dtype, d, groups, q_lens, kv_lens, counts, *, ps=64, maxp=8, hkv=2, bq=8,
                  seed=0):
    """One ragged call's inputs: q (Hq, T, D), a page pool of each lane's
    pages (at most maxp) plus spares, the descriptors and the tables (unused
    entries: scratch page 0), made from a seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tables = np.zeros((len(q_lens), maxp), np.int32)
    nxt = 1
    for s, kl in enumerate(kv_lens):
        for j in range(min(maxp, -(-kl // ps))):
            tables[s, j] = nxt
            nxt += 1
    t = sum(counts) * bq
    q = torch.randn((groups * hkv, t, d), generator=gen, device="cuda", dtype=dtype)
    kp = torch.randn((hkv, nxt + 3, ps, d), generator=gen, device="cuda", dtype=dtype)
    vp = torch.randn((hkv, nxt + 3, ps, d), generator=gen, device="cuda", dtype=dtype)
    desc = [torch.tensor(np.asarray(x), dtype=torch.int32, device="cuda")
            for x in (starts, counts, q_lens, kv_lens, tables)]
    return q, kp, vp, desc


def _ragged_decode_batch(dtype, d, groups, ps=64, maxp=8, seed=0):
    """A decode step's batch (max_q_blocks 1, every region one q block):
    lanes of 1 token at kv_len 1, ending on a page boundary, using all
    max_pages, with a last split of one partial page (two 64-column tiles
    a split: kv_len 138 leaves tile 2 with 10 columns), a verify region of
    q_len 4 whose first row's frontier ends one page before the block's
    (kv_len 258: rows 0 and 1 sit at 254 and 255, so at page size 64 the
    last split, tile 4 alone, is all masked for them), a q_len 3 region,
    an inactive lane. Every region with work has padding rows (q_len <
    block_q)."""
    cap = maxp * ps
    q_lens = [1, 1, 1, 1, 4, 3, 0]
    kv_lens = [1, 2 * ps, cap, 138, 4 * 64 + 2, 70, 0]
    return _ragged_batch(dtype, d, groups, q_lens, kv_lens, [1] * 7, ps=ps, maxp=maxp,
                         seed=seed), dict(block_q=8, max_q_blocks=1)


def _ragged_mixed_batch(dtype, d, groups, ps=64, maxp=8, seed=0):
    """A mixed tick's batch (max_q_blocks 32): a fresh 100-token chunk in a
    16-block region (several 64-row tiles; padding rows in its last working
    q block, 12, and three q blocks without work after it) and a 37-token
    one at offset 128, a full 256-token chunk at offset 64, decode lanes
    (one on a page boundary), a verify region (q_len 4), an inactive
    lane."""
    q_lens = [100, 1, 4, 0, 37, 256, 1]
    kv_lens = [100, 300, 196, 0, 128 + 37, 320, 2 * ps]
    counts = [16, 1, 1, 1, 5, 32, 1]
    return _ragged_batch(dtype, d, groups, q_lens, kv_lens, counts, ps=ps, maxp=maxp,
                         seed=seed), dict(block_q=8, max_q_blocks=32)


_RAGGED_BATCHES = {"decode": _ragged_decode_batch, "mixed": _ragged_mixed_batch}


def _check_ragged(batch, kw, dtype):
    q, kp, vp, desc = batch
    before = ops.RAGGED.launches
    out = ops.ragged_paged_attention(q, kp, vp, *desc, **kw)
    assert ops.RAGGED.launches == before + 1
    q_scaled = (q.float() / np.sqrt(q.shape[-1])).to(dtype)
    ref = ops.ragged_reference_attention(q_scaled, kp, vp, *desc, **kw)
    torch.cuda.synchronize()
    tol = TOLS[dtype]
    assert out.dtype == dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["decode", "mixed"])
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ragged_kernels_match_plain(cuda, dtype, d, groups, batch):
    """The bf16 split decode walk + combine (decode) and tile kernel
    (mixed), and the f32 FMA kernel, against ragged_reference_attention,
    padding rows and q blocks without work included: GQA groups 1, 4 and 8
    (64-row tiles of 8, 2 and 1 q blocks)."""
    inputs, kw = _RAGGED_BATCHES[batch](dtype, d, groups)
    _check_ragged(inputs, kw, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["decode", "mixed"])
@pytest.mark.parametrize("ps", [16, 40, 128])
def test_ragged_bf16_kernels_other_page_sizes(cuda, ps, batch):
    """Page sizes that gather several pages into one 64-column tile (16),
    straddle tiles (40) or fill two tiles (128)."""
    inputs, kw = _RAGGED_BATCHES[batch](torch.bfloat16, 128, 4, ps=ps, maxp=512 // ps)
    _check_ragged(inputs, kw, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_ragged_bf16_decode_splits_that_reuse_the_ring(cuda, d):
    """The serve shape of a decode step (8 lanes x 8 kv heads, GQA 4, 16
    pages of 64): the split plan gives 4 tiles a split, so a split's walk
    reuses the first of its three ring stages."""
    q_lens = [1] * 8
    kv_lens = [80, 199, 318, 438, 557, 677, 796, 1024]
    inputs = _ragged_batch(torch.bfloat16, d, 4, q_lens, kv_lens, [1] * 8, maxp=16, hkv=8)
    _check_ragged(inputs, dict(block_q=8, max_q_blocks=1), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["decode", "mixed"])
def test_ragged_bf16_kernels_are_deterministic_and_scale_q_as_the_dispatcher(cuda, batch):
    """Two calls are bitwise equal (each output row has one owner; split
    partials combine in split order), and the kernels' own scaling of q is
    bitwise the dispatcher's bf16(f32(q) * f32(sm_scale)): unscaled q with
    the scale equals q scaled beforehand with scale 1."""
    (q, kp, vp, desc), kw = _RAGGED_BATCHES[batch](torch.bfloat16, 128, 4, seed=3)
    scale = 1.0 / np.sqrt(q.shape[-1])
    first = _ragged_cuda(q, kp, vp, *desc, sm_scale=scale, **kw)
    second = _ragged_cuda(q, kp, vp, *desc, sm_scale=scale, **kw)
    prescaled = _ragged_cuda((q.float() * scale).to(q.dtype), kp, vp, *desc, sm_scale=1.0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, prescaled)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 3])
def test_ragged_bf16_decode_with_an_odd_count_of_partial_rows(cuda, groups):
    """block_q 1, 3 lanes, 1 kv head and 5 tiles a walk: 3 splits, so the
    workspace holds an odd number of partial rows (3 x 3 x groups) and
    its accumulators must still start on 16 bytes for the combine's
    float4 loads at D 128."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_splits, _ = _split_plan(3, 1, 5, 64, sms)
    assert (3 * n_splits * groups) % 2 == 1
    inputs = _ragged_batch(torch.bfloat16, 128, groups, [1, 1, 1], [300, 5 * 64, 1], [1] * 3,
                           maxp=5, hkv=1, bq=1)
    _check_ragged(inputs, dict(block_q=1, max_q_blocks=1), torch.bfloat16)


# (B, Hq, Hkv, Sq, Skv, D). The bf16 kernel's tiles are 64 rows: S 37 is
# under one tile, 64 exactly one, 65 and 129 one row past an edge, 200 a
# ragged fourth tile, 1024 sixteen whole ones; 100 x 333 (not causal) has
# Sq != Skv with both edges ragged.
_FWD_SHAPES = {
    "gqa_d128_s200_b2": (2, 8, 2, 200, 200, 128),
    "mha_d64_s37": (1, 2, 2, 37, 37, 64),
    "gqa_d64_s64": (1, 4, 2, 64, 64, 64),
    "mha_d128_s65_b3": (3, 2, 2, 65, 65, 128),
    "gqa_d64_s129_b3": (3, 4, 1, 129, 129, 64),
    "mha_d64_s200": (1, 3, 3, 200, 200, 64),
    "gqa_d128_s1024": (1, 8, 2, 1024, 1024, 128),
    "mha_d64_s1024": (1, 4, 4, 1024, 1024, 64),
    "gqa_d64_100x333": (1, 4, 2, 100, 333, 64),
    "mha_d128_100x333_b3": (3, 2, 2, 100, 333, 128),
}


def _fwd_inputs(dtype, shape, seed=1):
    b, hq, hkv, sq, skv, d = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((b, hkv, skv, d), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((b, hkv, skv, d), generator=gen, device="cuda", dtype=dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "shape,causal",
    [(name, causal) for name, dims in _FWD_SHAPES.items() for causal in (False, True)
     if not causal or dims[3] == dims[4]])  # the causal kernel requires Sq == Skv
def test_flash_kernel_matches_plain(cuda, dtype, shape, causal):
    """out and lse of the forward kernel against _flash_fwd_plain (bf16 on
    wgmma, f32 on FMAs), D 64 and 128, MHA and GQA, batch 1 to 3."""
    dims = _FWD_SHAPES[shape]
    q, k, v = _fwd_inputs(dtype, dims)
    before = ops.FLASH_FWD.launches
    out, lse = ops.flash_attention_with_lse(q, k, v, causal=causal)
    assert ops.FLASH_FWD.launches == before + 1
    ref, ref_lse = _flash_fwd_plain(q, k, v, causal, 1.0 / np.sqrt(dims[-1]))
    torch.cuda.synchronize()
    tol = TOLS[dtype]
    assert out.dtype == dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["gqa_d128_s200_b2", "mha_d64_s1024", "gqa_d64_100x333"])
def test_flash_fwd_kernel_is_deterministic(cuda, shape):
    """Every output row has one owner block and a fixed summation order, so
    two calls give bitwise equal out and lse."""
    dims = _FWD_SHAPES[shape]
    q, k, v = _fwd_inputs(torch.bfloat16, dims, seed=5)
    causal = dims[3] == dims[4]
    first = ops.flash_attention_with_lse(q, k, v, causal=causal)
    second = ops.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_kernel_wrappers_raise_instead_of_falling_back(cuda):
    q, kp, vp, desc, kw = _ragged_inputs(torch.float32, 64)
    with pytest.raises(ValueError, match="head_dim"):
        ops.ragged_paged_attention(q[..., :16].contiguous(), kp[..., :16].contiguous(),
                                   vp[..., :16].contiguous(), *desc, **kw)
    x = torch.zeros((1, 2, 8, 16), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(x, x, x)
    with pytest.raises(TypeError):
        ops.flash_attention(x.half(), x.half(), x.half())
    lse = torch.zeros((1, 2, 8, 1), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        _flash_bwd_cuda(x, x, x, x, lse, x, True, 0.25)
    y = torch.zeros((1, 2, 8, 64), device="cuda")
    with pytest.raises(TypeError):
        _flash_bwd_cuda(y.half(), y.half(), y.half(), y.half(), lse, y.half(), True, 0.125)
    with pytest.raises(ValueError, match="lse"):
        _flash_bwd_cuda(y, y, y, y, lse[..., 0], y, True, 0.125)


def _bwd_inputs(dtype, shape, causal, seed=2):
    b, hq, hkv, s, d = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    do = torch.randn((b, hq, s, d), generator=gen, device="cuda", dtype=dtype)
    out, lse = _flash_fwd_plain(q, k, v, causal, 1.0 / np.sqrt(d))
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "shape",
    [(2, 4, 4, 200, 64), (1, 8, 2, 131, 128), (1, 2, 2, 37, 64), (1, 4, 2, 129, 64),
     (2, 8, 2, 65, 128)],
    ids=["mha_d64", "gqa_d128", "short_d64", "edge_d64", "gqa_edge_d128"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_kernels_match_plain(cuda, dtype, shape, causal):
    """dq, dk, dv of both backward kernels against _flash_bwd_plain; S 200
    and 131 leave a ragged last tile, GQA 8/2 sums four heads per kv head.
    The bf16 kernels' tiles are 64 rows: S 37 is under one tile, S 129 and
    65 are one row past a tile edge."""
    q, k, v, out, lse, do = _bwd_inputs(dtype, shape, causal)
    scale = 1.0 / np.sqrt(shape[-1])
    before = (ops.FLASH_BWD_DKV.launches, ops.FLASH_BWD_DQ.launches)
    grads = _flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    assert (ops.FLASH_BWD_DKV.launches, ops.FLASH_BWD_DQ.launches) == (before[0] + 1, before[1] + 1)
    ref = _flash_bwd_plain(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    tol = TOLS[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 12, 300, 64), (1, 8, 2, 200, 128)],
                         ids=["mha_d64", "gqa_d128"])
def test_flash_bwd_kernels_are_deterministic(cuda, shape):
    """Every gradient element has one owner block and a fixed summation
    order (no atomics), so two calls give bitwise equal dq, dk and dv."""
    q, k, v, out, lse, do = _bwd_inputs(torch.bfloat16, shape, True, seed=4)
    scale = 1.0 / np.sqrt(shape[-1])
    first = _flash_bwd_cuda(q, k, v, out, lse, do, True, scale)
    second = _flash_bwd_cuda(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_attention_autograd_on_card_launches_backward_kernels(cuda):
    """flash_attention's gradient on CUDA tensors goes through both kernels
    and matches autograd of the reference in f32; dO arrives as a
    non-contiguous view."""
    q, k, v, _, _, do = _bwd_inputs(torch.float32, (1, 4, 2, 96, 64), True, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ops.FLASH_BWD_DQ.launches
    out = ops.flash_attention(*leaves, causal=True)
    (out.transpose(1, 2) * do.transpose(1, 2)).sum().backward()
    assert ops.FLASH_BWD_DQ.launches == before + 1
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    (ops.mha_reference(*refs, causal=True) * do).sum().backward()
    for got, want in zip(leaves, refs):
        torch.testing.assert_close(got.grad, want.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu_step(cuda):
    """Three f32 steps of a small Llama-shaped model (head_dim 64, GQA) on
    the card, through the flash kernels, against the same steps on the
    CPU's plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = TransformerConfig(
        vocab_size=512, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=256,
        max_seq=128, pos_emb="rope", norm="rmsnorm", act="swiglu", use_bias=False,
        tie_embeddings=False, dtype=torch.float32,
    )
    params = init_params(config, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (4, 97)))
    runs = {}
    for device in ("cpu", "cuda"):
        opt = default_optimizer(1e-2, warmup_steps=1, total_steps=3)
        state = create_train_state(config, opt, params=params, device=device)
        _, _, grads = loss_and_grads(config, state.params, tokens.to(device))
        step = make_train_step(config, opt, device=device)
        before = ops.FLASH_BWD_DKV.launches
        metrics = []
        for _ in range(3):
            state, m = step(state, {"tokens": tokens})
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        runs[device] = (metrics, [g.cpu() for g in grads],
                        [t.detach().cpu() for t in tree_leaves(state.params)],
                        ops.FLASH_BWD_DKV.launches - before)
    assert runs["cpu"][3] == 0 and runs["cuda"][3] == 3 * config.n_layers
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4, rtol=1e-4)
    for got, want in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for got, want in zip(runs["cuda"][2], runs["cpu"][2]):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_engine_on_card_matches_plain_engine_greedy(cuda):
    """A small Llama-shaped model (head_dim 64, GQA) served on the card,
    through the ragged kernel, gives the CPU plain path's greedy tokens."""
    config = TransformerConfig(
        vocab_size=512, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=256,
        max_seq=256, pos_emb="rope", norm="rmsnorm", act="swiglu", use_bias=False,
        tie_embeddings=False, dtype=torch.float32,
    )
    params = init_params(config, 0, device="cpu")
    engine_config = PagedEngineConfig(max_slots=2, paged=PagedConfig(
        page_size=16, num_pages=32, max_pages_per_slot=8, chunk_pages=2))
    prompts = [list(range(1, 40)), [7, 8, 9]]
    outs = {}
    for device in ("cpu", "cuda"):
        on_device = {k: ({kk: vv.to(device) for kk, vv in v.items()} if k == "blocks"
                         else v.to(device)) for k, v in params.items()}
        engine = PagedLLMEngine(config, on_device, engine_config, device=device)
        try:
            outs[device] = [engine.generate(p, max_tokens=8) for p in prompts]
        finally:
            engine.shutdown()
    assert outs["cuda"] == outs["cpu"]
