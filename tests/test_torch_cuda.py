"""ray_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc: it is marked `cuda` and
skips elsewhere. Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

This file imports no JAX (`--noconftest` skips tests/conftest.py, which
does), so it runs where only PyTorch is installed.

Tolerances: bf16 atol = rtol = 2e-2. The bf16 ragged kernels round p to
bf16 before P.V while `ragged_reference_attention` keeps p in f32: a
relative error of up to 2^-9 in each weight, which with f32 sums in
another order moves an output by up to about one bf16 ulp. The flash
plain versions round p where the kernels do, so there only the order of
the f32 sums (and exp2) differs, which can move the final bf16 rounding by
one ulp. f32 atol = rtol = 1e-4 (f32 sums in another order). The engine's
graphs are held bitwise against the same passes run eagerly on the card.
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
from ray_tpu_torch.models import forward
from ray_tpu_torch.models.transformer import decode_step
from ray_tpu_torch.serve.llm import (
    EngineConfig,
    LLMEngine,
    PagedConfig,
    PagedEngineConfig,
    PagedLLMEngine,
)
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
    # the dense engine's prefill buckets at Llama-3-8B's heads: 16 and 32
    # rows are under one tile
    "llama_gqa32_8_s16": (1, 32, 8, 16, 16, 128),
    "llama_gqa32_8_s32": (1, 32, 8, 32, 32, 128),
    "llama_gqa32_8_s1024": (1, 32, 8, 1024, 1024, 128),
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


# ------------------------------------------------------------ engine graphs

_GRAPH_MODEL = TransformerConfig(  # head_dim 128, GQA 4/1 as Llama-3's groups
    vocab_size=512, d_model=512, n_layers=2, n_heads=4, n_kv_heads=1, d_ff=1024,
    max_seq=256, pos_emb="rope", norm="rmsnorm", act="swiglu", use_bias=False,
    tie_embeddings=False, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
)
_GRAPH_PAGED = PagedConfig(page_size=16, num_pages=64, max_pages_per_slot=8, chunk_pages=2)


def _graph_engine(**engine_kw):
    params = init_params(_GRAPH_MODEL, 0, device="cuda")
    config = PagedEngineConfig(max_slots=4, decode_block_steps=4, paged=_GRAPH_PAGED,
                               **engine_kw)
    engine = PagedLLMEngine(_GRAPH_MODEL, params, config, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for pool in engine.cache.values():  # earlier chunks' KV for the passes to read
        pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda"))
    engine._tokens_dev.copy_(torch.randint(1, 512, (4,), generator=gen, device="cuda"))
    return engine


def _mixed_pass_inputs(engine, b, rng):
    """b prefill lanes (even lanes a fresh chunk, odd lanes one at the
    second chunk, each shorter than the last) and max_slots decode lanes,
    the last inactive; every lane on pages of its own."""
    pc, ms = engine.paged, engine.config.max_slots
    ps, cp, maxp, ct = pc.page_size, pc.chunk_pages, pc.max_pages_per_slot, pc.chunk_tokens
    pages = iter(range(1, pc.num_pages))
    page_rows = np.zeros((b + ms, maxp), np.int32)
    chunk_ids = np.zeros((b, cp), np.int64)
    tokens = np.zeros((b, ct), np.int64)
    offsets, totals = np.zeros((b,), np.int64), np.zeros((b,), np.int64)
    for lane in range(b):
        offset, n_real = ct * (lane % 2), ct - 3 * lane
        own = [next(pages) for _ in range((offset + ct) // ps)]
        page_rows[lane, :len(own)] = own
        chunk_ids[lane] = own[offset // ps: offset // ps + cp]
        tokens[lane, :n_real] = rng.integers(1, 512, n_real)
        offsets[lane], totals[lane] = offset, offset + n_real
    dec_positions, dec_active = np.zeros((ms,), np.int64), np.zeros((ms,), np.int64)
    for i in range(ms - 1):
        own = [next(pages) for _ in range((5 + 9 * i) // ps + 1)]
        page_rows[b + i, :len(own)] = own
        dec_positions[i], dec_active[i] = 5 + 9 * i, 1
    return dict(page_rows=page_rows, chunk_ids=chunk_ids, tokens=tokens, offsets=offsets,
                totals=totals, dec_positions=dec_positions, dec_active=dec_active)


def _decode_pass_inputs(engine, variant, temp):
    """max_slots lanes at positions 9, 30, 51, ..., the last not dispatched
    (its token must stay); `filtered` adds top-k / top-p per lane."""
    pc, ms = engine.paged, engine.config.max_slots
    tables = np.zeros((ms, pc.max_pages_per_slot), np.int32)
    positions = np.zeros((ms,), np.int64)
    for i in range(ms):
        positions[i] = 9 + 21 * i
        n = (positions[i] + engine.config.decode_block_steps - 1) // pc.page_size + 1
        tables[i, :n] = np.arange(1, n + 1) + 8 * i
    mask = np.arange(ms) < ms - 1
    inputs = dict(block_tables=tables, positions=positions, mask=mask,
                  temps=np.full((ms,), temp, np.float32))
    if variant == "filtered":
        inputs.update(top_ks=np.array([0, 5, 1, 50][:ms], np.int64),
                      top_ps=np.array([0.9, 1.0, 1.0, 0.5][:ms], np.float32))
    return inputs


def _engine_state(engine):
    return [engine.cache["k"].clone(), engine.cache["v"].clone(), engine._tokens_dev.clone()]


def _restore(engine, state):
    for dst, src in zip((engine.cache["k"], engine.cache["v"], engine._tokens_dev), state):
        dst.copy_(src)


def _as_list(out):
    return [t.clone() for t in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed.1", "mixed.2", "mixed.4", "decode.plain",
                                  "decode.filtered"])
def test_engine_graph_replay_matches_eager_pass(cuda, name):
    """Each pass replayed from its CUDA graph against the same pass run
    eagerly on the card, on the same inputs and the same pool: bitwise
    equal logits (mixed) or tokens (decode, greedy), pool and token vector.
    The graph is captured first: its warm-up writes the scratch page, which
    the passes then write alike. Its capture recorded one ragged launch per
    layer (mixed) or per layer and step (decode)."""
    engine = _graph_engine()
    try:
        kind, _, which = name.partition(".")
        if kind == "mixed":
            p = engine._mixed[int(which)]
            inputs = _mixed_pass_inputs(engine, int(which), np.random.default_rng(0))
        else:
            p = engine._decode[which]
            inputs = _decode_pass_inputs(engine, which, temp=0.0)
        p.capture()
        before = _engine_state(engine)
        eager = _as_list(p.run_eager(**inputs))
        after_eager = _engine_state(engine)
        _restore(engine, before)
        graphed = _as_list(p(**inputs))
        after_graph = _engine_state(engine)
        torch.cuda.synchronize()
        assert p.is_captured and p.runs == 1
        names = [f"output {i}" for i in range(len(eager))] + ["pool k", "pool v", "tokens"]
        for label, e, g in zip(names, eager + after_eager, graphed + after_graph):
            where = (e != g).nonzero()[:4].tolist()
            assert torch.equal(e, g), f"{label} differs at {where}"
        assert not torch.equal(after_graph[0], before[0])  # the pass wrote the pool
        layers = _GRAPH_MODEL.n_layers
        want = layers if kind == "mixed" else layers * engine.config.decode_block_steps
        assert p.captured[f"ragged.{kind}"] == want and p.captured["ragged_paged_attention"] == want
        if kind == "decode":
            assert torch.equal(after_graph[2][-1], before[2][-1])  # the lane left out keeps its token
    finally:
        engine.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "filtered"])
def test_engine_decode_graph_draws_new_numbers_each_replay(cuda, variant):
    """Two replays of a decode graph at temperature 1 from equal inputs and
    an equal pool draw different tokens: the sampler's generator is
    registered with the graph and advances across replays."""
    engine = _graph_engine()
    try:
        p = engine._decode[variant]
        inputs = _decode_pass_inputs(engine, variant, temp=1.0)
        state = _engine_state(engine)
        first = p(**inputs).clone()
        _restore(engine, state)
        second = p(**inputs).clone()
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0])  # the input row
        assert not torch.equal(first[1:, :-1], second[1:, :-1])
        assert bool(((first >= 0) & (first < _GRAPH_MODEL.vocab_size)).all())
    finally:
        engine.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("max_inflight_blocks", [1, 8])
def test_engine_graphs_give_the_eager_passes_greedy_tokens(cuda, monkeypatch, max_inflight_blocks):
    """The engine with every pass captured up front (precompile) gives the
    greedy tokens of the same engine whose passes run eagerly on the card;
    its launch accounting is replays x captured, and no pass ran through a
    kernel wrapper after the capture."""
    from ray_tpu_torch.serve.llm.graphs import DevicePass

    prompts = [list(range(1, 40)), [7, 8, 9], list(range(100, 170)), [5] * 20, [11, 12]]
    engine = _graph_engine(precompile=True, max_inflight_blocks=max_inflight_blocks)
    try:
        assert all(p.is_captured for p in engine.passes()) and engine.capture_s > 0
        wrapper = ops.RAGGED.launches
        streams = [engine.submit(p, max_tokens=9) for p in prompts]
        graphed = [s.result(timeout=120) for s in streams]
        stats = engine.stats()
        assert ops.RAGGED.launches == wrapper
    finally:
        engine.shutdown()
    mixed = sum(stats[f"passes.mixed.{b}"] for b in (1, 2, 4))
    decode = stats["passes.decode.plain"] + stats["passes.decode.filtered"]
    assert stats["launches.ragged.mixed"] == mixed * _GRAPH_MODEL.n_layers
    assert stats["launches.ragged.decode"] == decode * _GRAPH_MODEL.n_layers * 4
    monkeypatch.setattr(DevicePass, "__call__", DevicePass.run_eager)
    engine = _graph_engine(max_inflight_blocks=max_inflight_blocks)
    try:
        streams = [engine.submit(p, max_tokens=9) for p in prompts]
        eager = [s.result(timeout=120) for s in streams]
        assert not any(p.is_captured for p in engine.passes())
    finally:
        engine.shutdown()
    assert graphed == eager


# ---------------------------------------------- speculative decoding, prefix

_SPEC = 3


def _spec_engine(**engine_kw):
    """The graph engine's model with speculative decoding (verify rounds of
    up to 1 + 3 tokens), the pool filled with random KV."""
    return _graph_engine(speculative_tokens=_SPEC, **engine_kw)


def _verify_pass_inputs(engine, b, rng, temp):
    """A mixed tick's prefill lanes (`_mixed_pass_inputs`) with verify
    rounds on the decode lanes: lane i at position 5 + 9i with 1 + (3 - i)
    tokens, on pages of its own covering the whole round; the last lane
    inactive. temps / top-k / top-p per lane (lane 1 filtered)."""
    pc, ms = engine.paged, engine.config.max_slots
    inputs = _mixed_pass_inputs(engine, b, rng)
    width = _SPEC + 1
    dec_tokens = rng.integers(1, 512, (ms, width)).astype(np.int64)
    dec_positions, dec_active = np.zeros((ms,), np.int64), np.zeros((ms,), np.int64)
    for i in range(ms - 1):
        count = width - i
        n = (5 + 9 * i + count - 1) // pc.page_size + 1
        inputs["page_rows"][b + i] = 0
        inputs["page_rows"][b + i, :n] = 40 + 4 * i + np.arange(n)
        dec_positions[i], dec_active[i] = 5 + 9 * i, count
    inputs.update(dec_tokens=dec_tokens, dec_positions=dec_positions, dec_active=dec_active,
                  temps=np.full((ms,), temp, np.float32),
                  top_ks=np.array([0, 5, 0, 0][:ms], np.int64),
                  top_ps=np.array([1.0, 0.9, 1.0, 1.0][:ms], np.float32))
    return inputs


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 4])
def test_engine_verify_graph_replay_matches_eager_pass(cuda, b):
    """Each verify pass (a mixed tick whose decode lanes score 1 + drafts
    tokens, with the accept step inside) replayed from its CUDA graph
    against the same pass run eagerly on the card, greedy: bitwise equal
    prefill logits, packed tokens + counts, pool (its scratch page aside)
    and token vector. Its capture recorded one tile-kernel ragged launch
    per layer and no decode launch."""
    engine = _spec_engine()
    try:
        p = engine._mixed[b]
        assert p.name == f"verify.{b}" and not engine._decode
        inputs = _verify_pass_inputs(engine, b, np.random.default_rng(b), temp=0.0)
        p.capture()
        before = _engine_state(engine)
        eager = _as_list(p.run_eager(**inputs))
        after_eager = _engine_state(engine)
        _restore(engine, before)
        graphed = _as_list(p(**inputs))
        after_graph = _engine_state(engine)
        torch.cuda.synchronize()
        # every layer's scratch page left out of the pool: a verify round's
        # rows past its count, and inactive lanes, all write row 0 of page
        # 0, in an order neither run defines
        keep = torch.ones(after_graph[0].shape[1], dtype=torch.bool, device="cuda")
        keep[torch.arange(_GRAPH_MODEL.n_layers) * engine.paged.num_pages] = False
        names = ["logits", "packed", "pool k", "pool v", "tokens"]
        for label, e, g in zip(names, eager + after_eager, graphed + after_graph):
            if label.startswith("pool"):
                e, g = e[:, keep], g[:, keep]
            where = (e != g).nonzero()[:4].tolist()
            assert torch.equal(e, g), f"{label} differs at {where}"
        packed = graphed[1].cpu().numpy()
        counts = inputs["dec_active"]
        assert ((packed[:, -1] >= 1) == (counts > 0)).all() and (packed[:, -1] <= counts).all()
        assert p.captured["ragged.mixed"] == _GRAPH_MODEL.n_layers
        assert "ragged.decode" not in p.captured
    finally:
        engine.shutdown()


@pytest.mark.cuda
def test_engine_verify_graph_draws_new_numbers_each_replay(cuda):
    """Two replays of a sampled verify round (temperature 1) from equal
    inputs and an equal pool draw different tokens: the engine's generator
    is registered with the verify graph and advances across replays."""
    engine = _spec_engine()
    try:
        p = engine._mixed[1]
        inputs = _verify_pass_inputs(engine, 1, np.random.default_rng(3), temp=1.0)
        state = _engine_state(engine)
        first = p(**inputs)[1].clone()
        _restore(engine, state)
        second = p(**inputs)[1].clone()
        torch.cuda.synchronize()
        assert not torch.equal(first, second)
        tokens = first[:, :-1]
        assert bool(((tokens >= 0) & (tokens < _GRAPH_MODEL.vocab_size)).all())
    finally:
        engine.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_copy_page_on_card_matches_cpu(cuda, dtype):
    """copy_page on the card moves every layer's stripe of one page and
    nothing else: bitwise the CPU's result."""
    from ray_tpu_torch.serve.llm.paged import copy_page

    gen = torch.Generator()
    gen.manual_seed(0)
    pool = {k: torch.randn((8, 4 * 32, 16, 128), generator=gen).to(dtype) for k in ("k", "v")}
    card = {k: v.cuda() for k, v in pool.items()}
    copy_page(pool, 5, 9, n_layers=4)
    copy_page(card, 5, 9, n_layers=4)
    torch.cuda.synchronize()
    for k in pool:
        assert torch.equal(card[k].cpu(), pool[k])
        assert torch.equal(pool[k][:, 9 + 32 * 3], pool[k][:, 5 + 32 * 3])


@pytest.mark.cuda
def test_spec_engine_greedy_tokens_equal_at_1_and_8_blocks_in_flight(cuda, monkeypatch):
    """The spec engine (n-gram drafts) with every verify pass captured up
    front gives the same greedy tokens at 1 and at 8 blocks in flight, and
    the tokens of the same engine whose passes run eagerly on the card;
    its ragged launches are verify replays x layers, all on the tile
    kernel, none through the wrapper after the capture."""
    from ray_tpu_torch.serve.llm.graphs import DevicePass

    prompts = [[3, 4, 5] * 9, [7, 8, 9], list(range(100, 170)), [5] * 20, [11, 12] * 4]
    outs = {}
    for mode, inflight in (("graphs", 1), ("graphs", 8), ("eager", 8)):
        if mode == "eager":
            monkeypatch.setattr(DevicePass, "__call__", DevicePass.run_eager)
        engine = _spec_engine(precompile=mode == "graphs", max_inflight_blocks=inflight)
        try:
            wrapper = ops.RAGGED.launches
            streams = [engine.submit(p, max_tokens=12) for p in prompts]
            outs[mode, inflight] = [s.result(timeout=120) for s in streams]
            stats = engine.stats()
            if mode == "graphs":
                assert ops.RAGGED.launches == wrapper
                verify = sum(stats[f"passes.verify.{b}"] for b in (1, 2, 4))
                assert stats["launches.ragged.mixed"] == verify * _GRAPH_MODEL.n_layers
                assert "launches.ragged.decode" not in stats
                assert stats["spec_proposed"] > 0 and stats["pages_free"] == 63
        finally:
            engine.shutdown()
    assert outs["graphs", 1] == outs["graphs", 8] == outs["eager", 8]


@pytest.mark.cuda
def test_draft_model_proposer_launches_flash_forward_on_card(cuda):
    """The draft-model proposer's prefill runs the flash forward kernel on
    the card (B 1, S = window, causal) and drafts what the plain version
    drafts from the same f32 weights."""
    config = TransformerConfig(
        vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=512,
        max_seq=256, pos_emb="rope", norm="rmsnorm", act="swiglu", use_bias=False,
        tie_embeddings=False, dtype=torch.float32,
    )
    from ray_tpu_torch.serve.llm.speculative import DraftModelProposer

    params = init_params(config, 0, device="cpu")
    card = {k: ({kk: vv.cuda() for kk, vv in v.items()} if k == "blocks" else v.cuda())
            for k, v in params.items()}
    ctx = list(range(3, 40))
    before = ops.FLASH_FWD.launches
    got = DraftModelProposer(config, card, window=64).propose(ctx, 4)
    assert ops.FLASH_FWD.launches - before == 4 * config.n_layers
    assert got == DraftModelProposer(config, params, window=64).propose(ctx, 4)


# ------------------------------------------------- dense engine, preemption


@pytest.mark.cuda
def test_dense_engine_on_card_matches_cpu_engine_greedy(cuda):
    """The dense LLMEngine on the card (decode step as a CUDA graph, prefill
    through the flash kernel) gives the CPU engine's greedy tokens on a
    small f32 model."""
    config = _GRAPH_MODEL.replace(dtype=torch.float32, param_dtype=torch.float32)
    params = init_params(config, 0, device="cpu")
    prompts = [list(range(1, 40)), [7, 8, 9], list(range(100, 150))]
    outs = {}
    for device in ("cpu", "cuda"):
        on_device = {k: ({kk: vv.to(device) for kk, vv in v.items()} if k == "blocks"
                         else v.to(device)) for k, v in params.items()}
        engine = LLMEngine(config, on_device, EngineConfig(max_slots=2, max_seq=128),
                           device=device)
        try:
            flash = ops.FLASH_FWD.launches
            outs[device] = [s.result(timeout=120)
                            for s in [engine.submit(p, max_tokens=8) for p in prompts]]
            if device == "cuda":
                assert engine._decode.is_captured
                assert ops.FLASH_FWD.launches - flash == len(prompts) * config.n_layers
        finally:
            engine.shutdown()
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_dense_decode_graph_matches_eager_decode_step(cuda):
    """One replay of the dense engine's decode graph against eager
    `decode_step` + argmax on the same cache, tokens and positions (lanes at
    mixed positions, GQA 4/1, bf16): bitwise equal tokens and cache."""
    params = init_params(_GRAPH_MODEL, 0, device="cuda")
    engine = LLMEngine(_GRAPH_MODEL, params, EngineConfig(max_slots=4, max_seq=128),
                       device="cuda")
    try:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        for cache in engine.cache.values():
            cache.copy_(torch.randn(cache.shape, generator=gen, device="cuda"))
        tokens = np.array([5, 77, 300, 511], np.int64)
        positions = np.array([0, 17, 64, 127], np.int64)
        temps = np.zeros((4,), np.float32)
        before = {k: v.clone() for k, v in engine.cache.items()}
        with torch.no_grad():
            graphed = engine._decode(tokens=tokens, positions=positions, temps=temps).clone()
            after_graph = {k: v.clone() for k, v in engine.cache.items()}
            for k, v in before.items():
                engine.cache[k].copy_(v)
            logits, _ = decode_step(params, engine.cache, torch.from_numpy(tokens).cuda(),
                                    torch.from_numpy(positions).cuda(), _GRAPH_MODEL,
                                    rope_tables=None)
            eager = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        assert engine._decode.is_captured and engine._decode.runs == 1
        assert torch.equal(graphed, eager)
        for k in before:
            assert torch.equal(after_graph[k], engine.cache[k]), k
            assert not torch.equal(after_graph[k], before[k])
    finally:
        engine.shutdown()


def _drain_all(engine):
    while engine._inflight:
        engine._pump_completed(wait=True)


def _step_by_hand(engine):
    engine._admit()
    engine._deadline_sweep()
    if not engine._mixed_tick():
        engine._dispatch_decode_block()
    _drain_all(engine)
    for i, slot in enumerate(engine.slots):
        if slot.request is not None and not slot.prefilling:
            engine._maybe_retire(i, slot.request)


@pytest.mark.cuda
def test_park_and_resume_on_card_with_graphs_and_8_blocks_in_flight(cuda, monkeypatch):
    """Four low-priority lanes decode through the captured graphs with 8
    blocks in flight when a priority-1 request arrives: the victim is
    marked (its blocks are in flight), parks once they drain, and resumes
    by re-prefilling its emitted tokens. Every stream ends full, each
    token scores within 1e-3 of the dense forward's argmax (f32;
    teacher-forced), and the allocator returns to full."""
    monkeypatch.setattr(PagedLLMEngine, "_loop", lambda self: None)
    config = _GRAPH_MODEL.replace(dtype=torch.float32, param_dtype=torch.float32)
    params = init_params(config, 0, device="cuda")
    engine = PagedLLMEngine(config, params, PagedEngineConfig(
        max_slots=4, decode_block_steps=4, max_inflight_blocks=8, precompile=True,
        paged=_GRAPH_PAGED), device="cuda")
    try:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, 512, n).tolist() for n in (20, 33, 47, 60)]
        lows = [engine.submit(p, max_tokens=48, priority=0) for p in prompts]
        engine._admit()
        while any(s.prefilling for s in engine.slots):
            assert engine._mixed_tick()
        for _ in range(8):
            assert engine._dispatch_decode_block()
        assert engine._inflight >= 8
        hp = rng.integers(1, 512, 24).tolist()
        high = engine.submit(hp, max_tokens=8, tenant="paid", priority=1)
        engine._admit()
        marked = [i for i, s in enumerate(engine.slots) if s.preempt_pending]
        assert len(marked) == 1 and engine.metrics["lane_preemptions"] == 0
        assert engine.slots[marked[0]].blocks_in_flight > 0
        _drain_all(engine)
        engine._admit()
        assert engine.metrics["lane_preemptions"] == 1
        assert engine.slots[marked[0]].request is high._request
        for _ in range(500):
            if all(s.free for s in engine.slots) and not len(engine._fair):
                break
            _step_by_hand(engine)
        outs = [s.result(timeout=10) for s in lows + [high]]
        stats = engine.stats()
        assert [len(o) for o in outs] == [48] * 4 + [8]
        assert stats["lane_resumes"] == 1 and stats["pages_free"] == _GRAPH_PAGED.num_pages - 1
        assert all(p.is_captured for p in engine.passes())
        with torch.no_grad():
            for prompt, out in zip(prompts + [hp], outs):
                seq = prompt + out
                logits = forward(params, torch.tensor([seq[:-1]], device="cuda"), config)[0]
                rows = logits[len(prompt) - 1:].float()
                chosen = torch.tensor(out, device="cuda")
                gap = rows.max(dim=-1).values - rows.gather(1, chosen[:, None])[:, 0]
                assert gap.max().item() <= 1e-3
    finally:
        engine.shutdown()


# ------------------------------------------------------- training entry point


class _TokenBlocks:
    def __init__(self, seed, n=6, size=300):
        self.seed, self.n, self.size = seed, n, size

    def iter_blocks(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.n):
            yield {"tokens": rng.integers(0, 256, self.size).astype(np.int32)}


@pytest.mark.cuda
def test_lm_batch_iterator_on_card_matches_the_cpu_batches(cuda):
    """The side-stream prefetch window hands over the same batches as the
    CPU feed, each with its copies' event; the consumer may read them at
    once (its stream waits on the event), and a slow consumer that
    allocates between batches still reads every batch intact."""
    from ray_tpu_torch.data import lm_batch_iterator

    ref = [b["tokens"].clone() for b in lm_batch_iterator(_TokenBlocks(0), 16, 4, device="cpu")]
    got = []
    for batch in lm_batch_iterator(_TokenBlocks(0), 16, 4, device="cuda"):
        assert batch["tokens"].is_cuda and batch.ready is not None
        scratch = torch.empty(1 << 20, device="cuda").fill_(7.0)  # reuse pressure on the allocator
        got.append((batch["tokens"] + 0).cpu())
        del scratch
    assert len(got) == len(ref) > 2
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_async_checkpoint_snapshots_card_state_before_returning(cuda, tmp_path):
    """save() of a state on the card copies it to pinned host memory and
    waits for the copies: an in-place update enqueued right after the call
    does not reach the file, and restore() puts the saved values back on
    the card bitwise, as leaf tensors that require grad."""
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.train import CheckpointManager

    config = get_config("gpt2-tiny")
    opt = default_optimizer(1e-3, total_steps=4)
    state = create_train_state(config, opt, 0, device="cuda")
    saved = [t.detach().clone() for t in tree_leaves(state.params)]
    mgr = CheckpointManager(tmp_path, async_save=True)
    assert mgr.save(0, state)
    with torch.no_grad():
        torch._foreach_add_(tree_leaves(state.params), 1.0)
    mgr.wait_until_finished()
    back = mgr.restore(state, device="cuda")
    for a, b in zip(saved, tree_leaves(back.params)):
        assert b.is_cuda and b.is_leaf and b.requires_grad and torch.equal(a, b)
    mgr.close()


@pytest.mark.cuda
def test_step_cost_of_a_card_trainer_launches_nothing(cuda):
    """The cost count of an LMTrainer on the card runs on meta tensors: no
    kernel launches, the live state untouched, the card's published peaks;
    two reported steps then launch each flash kernel once per layer."""
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.train import LMTrainer

    config = get_config("gpt2-tiny").replace(d_model=128, n_heads=2)  # head_dim 64: the kernels' size
    trainer = LMTrainer(config, learning_rate=1e-3, total_steps=4, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 65)))
    before = {k.name: k.launches for k in ops.KERNELS}
    wte = trainer.state.params["wte"].clone()
    cost = trainer.step_cost({"tokens": tokens})
    assert {k.name: k.launches for k in ops.KERNELS} == before
    assert torch.equal(wte, trainer.state.params["wte"])
    assert cost.flops > 0 and cost.device_kind == torch.cuda.get_device_name(0)
    reports = []
    trainer.train([{"tokens": tokens}] * 2, num_steps=2, report_every=1, report_fn=reports.append)
    assert [r["step"] for r in reports] == [1, 2] and all(0 < r["mfu"] < 1 for r in reports)
    assert ops.FLASH_FWD.launches - before["flash_attention_fwd"] == 2 * config.n_layers
    assert ops.FLASH_BWD_DQ.launches - before["flash_attention_bwd_dq"] == 2 * config.n_layers
