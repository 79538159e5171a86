"""ray_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc: it is marked `cuda` and
skips elsewhere. Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

This file imports no JAX (`--noconftest` skips tests/conftest.py, which
does), so it runs where only PyTorch is installed.

Tolerances: bf16 atol = rtol = 2e-2 (both sides compute in f32 from the
same bf16 inputs; a different summation order can move the final bf16
rounding by one ulp), f32 atol = rtol = 1e-4 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch import ops
from ray_tpu_torch.models import TransformerConfig, init_params
from ray_tpu_torch.ops.attention import _flash_fwd_plain
from ray_tpu_torch.serve.llm import PagedConfig, PagedEngineConfig, PagedLLMEngine

TOLS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _ragged_inputs(dtype, d, seed=0, hq=8, hkv=2, ps=64, maxp=8, bq=8):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q_lens = [64, 40, 1, 1, 4, 0]
    kv_lens = [64, 168, 65, 300, 130, 0]
    counts = [8, 8, 1, 1, 1, 1]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tables = np.zeros((len(q_lens), maxp), np.int32)
    nxt = 1
    for s, kl in enumerate(kv_lens):
        for j in range(-(-kl // ps)):
            tables[s, j] = nxt
            nxt += 1
    t = sum(counts) * bq
    q = torch.randn((hq, t, d), generator=gen, device="cuda", dtype=dtype)
    kp = torch.randn((hkv, nxt + 3, ps, d), generator=gen, device="cuda", dtype=dtype)
    vp = torch.randn((hkv, nxt + 3, ps, d), generator=gen, device="cuda", dtype=dtype)
    desc = [torch.tensor(np.asarray(x), dtype=torch.int32, device="cuda")
            for x in (starts, counts, q_lens, kv_lens, tables)]
    return q, kp, vp, desc, dict(block_q=bq, max_q_blocks=8)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda, dtype, causal):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    shape_q, shape_kv = (2, 8, 200, 128), (2, 2, 200, 128)
    q = torch.randn(shape_q, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(shape_kv, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(shape_kv, generator=gen, device="cuda", dtype=dtype)
    before = ops.FLASH_FWD.launches
    out, lse = ops.flash_attention_with_lse(q, k, v, causal=causal)
    assert ops.FLASH_FWD.launches == before + 1
    ref, ref_lse = _flash_fwd_plain(q, k, v, causal, 1.0 / np.sqrt(128))
    torch.cuda.synchronize()
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


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
