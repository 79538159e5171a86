#!/usr/bin/env python3
"""Drive the ray_tpu_torch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases (one line each, timed; any failure raises, so the exit code is
nonzero and no result line is printed):

1. env     — torch / CUDA / nvcc versions, the card's name and power limit.
2. build   — nvcc builds every kernel under ray_tpu_torch/ops/csrc/ (one
             process per source, started together); `cuobjdump -sass`
             counts each backward instance's wgmma (HGMMA) and
             asynchronous copies (LDGSTS, UTMALDG): a bf16 instance
             without HGMMA fails the phase.
3. kernels — each kernel against its plain PyTorch version, in bf16 and
             f32, with times, the card's bound and (flash) the PyTorch
             library yardstick: ragged and flash forward at the Llama-3-8B
             shapes of the serving path; the flash forward and both flash
             backward kernels at the GPT-2 124M shape of the train path
             (B 8, 12 heads, S 1024, D 64) and the backward kernels at a
             Llama shape too (GQA 32/8, S 931, D 128), where two runs must
             give bitwise equal gradients and delta = rowsum(dO * O) is
             timed apart from the two launches.
4. serve   — LLMServer("llama3-8b") at full width and depth on the card,
             random bf16 weights from a seeded torch.Generator, 8 greedy
             requests with prompts of 64-900 tokens, 32 new tokens each.
5. check   — the dense forward (flash kernel) over prompt + generated tokens
             of 2 requests: every engine token must score within a stated
             margin of the dense argmax.
6. train   — GPT-2 124M (gpt2-small) at full width and depth, f32 master
             weights from a seeded torch.Generator, bf16 compute:
             the kernel path's gradients against attn_impl="xla" on one
             smaller batch, then TRAIN_STEPS steps of make_train_step on one
             fixed 8 x 1025 batch; the loss must fall by the stated margin
             and each backward kernel must launch once per layer per step.

The line before the last lists every kernel with its launches on the main
paths (phases 4-5 and phase 6, each counted from zero just before it), its
error against the plain version and its times; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import count_params, forward, get_config
from ray_tpu_torch.ops import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    KERNELS,
    RAGGED,
    ragged_paged_attention,
)
from ray_tpu_torch.ops._build import build_all, sass_counts
from ray_tpu_torch.ops.attention import (
    _DTYPE_CODES,
    _LOG2E,
    _delta,
    _flash_bwd_cuda,
    _flash_bwd_plain,
    _flash_fwd_plain,
    flash_attention_with_lse,
)
from ray_tpu_torch.ops.ragged_paged_attention import _ragged_cuda, ragged_reference_attention
from ray_tpu_torch.serve.llm import LLMServer, PagedConfig, PagedEngineConfig
from ray_tpu_torch.train import (
    create_train_state,
    default_optimizer,
    global_norm,
    loss_and_grads,
    make_train_step,
)

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 FMA
SEED = 0
MODEL = "llama3-8b"
N_REQUESTS = 8
MAX_TOKENS = 32
CHECK_MARGIN = 0.25
TRAIN_MODEL = "gpt2-small"
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS = 20
TRAIN_WARMUP = 2  # steps left out of the step-time median
TRAIN_LR = 1e-3
# last loss < LOSS_MARGIN x first. The batch is 8192 uniform draws from
# 50257 ids (about 7.6 k distinct), so a model that has learnt only the
# batch's unigram distribution sits at ln(7.6 k) ~ 8.9 = 0.82 x ln(50257);
# going lower means memorizing by position and context, which takes far
# more than TRAIN_STEPS steps (the JAX package's tiny-vocab overfit test
# asks for 0.7x in 30). 0.85 asks for most of the way to that floor.
LOSS_MARGIN = 0.85
GRAD_CHECK_BATCH, GRAD_CHECK_SEQ = 2, 512
# kernel path vs attn_impl="xla" gradients in bf16 compute (see _grad_check)
GRAD_TOL_NORM = 0.01  # relative difference of the global norms
GRAD_TOL_DIFF = 0.05  # ||g_kernel - g_xla|| / ||g_xla|| over all leaves
GRAD_TOL_LEAF = 0.10  # the same per leaf, for leaves that hold >= 1e-3 of the norm
BWD_SHAPES = {  # (B, Hq, Hkv, S, D), causal
    "gpt2": (TRAIN_BATCH, 12, 12, TRAIN_SEQ, 64),
    "llama": (1, 32, 8, 931, 128),
}
REPLACES = {
    "ragged_paged_attention": "ray_tpu/ops/ragged_paged_attention.py:60",
    "flash_attention_fwd": "ray_tpu/ops/attention.py:83",
    "flash_attention_bwd_dkv": "ray_tpu/ops/attention.py:215",
    "flash_attention_bwd_dq": "ray_tpu/ops/attention.py:274",
}
SOURCES = {
    "ragged_paged_attention": "ray_tpu_torch/ops/csrc/ragged_paged_attention.cu",
    "flash_attention_fwd": "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
    "flash_attention_bwd_dkv": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


# ----------------------------------------------------------------- timing


class _Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the serving path reads different pages every layer, so a warm
    50 MB L2 would flatter the kernels). A 2 ms device-side sleep before
    the start event lets the host enqueue the whole call while the card is
    still busy, so a call that dispatches many kernels (autograd's
    backward, a plain version) is timed on the device, not on the host."""

    SLEEP_CYCLES = 4_000_000  # about 2 ms at the H100's ~2 GHz

    def __init__(self):
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases


def phase_env() -> str:
    t0 = time.perf_counter()
    nvcc = _run(["nvcc", "--version"]).splitlines()[-1]
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc: {nvcc} ({time.perf_counter() - t0:.2f} s)")
    print(card.splitlines()[0], flush=True)
    return card.splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build_all(KERNELS)
    for k in KERNELS:
        text = logs.get(k.name, k.build_log)
        regs = [int(w) for line in text.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(line.split("bytes spill stores")[0].split()[-1])
                     for line in text.splitlines() if "bytes spill stores" in line)
        log("build", f"{k.name}: built={k.built} instances={len(regs)} "
            f"max_registers={max(regs) if regs else 'n/a'} spill_store_bytes={spills}")
    log("build", f"done ({time.perf_counter() - t0:.2f} s)")
    _check_bwd_sass()


SASS_OPS = ("HGMMA", "LDGSTS", "UTMALDG")


def _check_bwd_sass() -> None:
    """wgmma and asynchronous copies in each backward instance's SASS; the
    bf16 instances (the train path's) must run their products on wgmma."""
    missing = []
    for fn, counts in sass_counts(FLASH_BWD_DKV, SASS_OPS).items():
        kind = "bf16" if "bfloat16" in fn else "f32"
        name = fn.split("flash_bwd_", 1)[-1].split("EEEv", 1)[0]
        log("build", f"sass flash_bwd_{name} ({kind}): " + " ".join(f"{op}={n}" for op, n in counts.items()))
        if kind == "bf16" and counts["HGMMA"] == 0:
            missing.append(name)
    if missing:
        raise AssertionError(f"bf16 backward instances without wgmma (HGMMA): {missing}")


def _ragged_case(dtype, gen):
    """A mixed batch at the serving path's Llama-3-8B shapes: prefill chunks
    (one fresh, one at offset 256, one partial at offset 512), decode lanes
    (one on a page boundary), a verify-shaped region (q_len 4) and an
    inactive lane, against the full 32-layer flat pool with layer 7's page
    offset folded into the tables. Unused table entries are scratch page 0."""
    hq, hkv, d, ps, maxp, bq, num_pages, layers = 32, 8, 128, 64, 16, 8, 256, 32
    chunk_blocks = 256 // bq
    q_lens = [256, 256, 100, 1, 1, 1, 4, 0]
    kv_lens = [256, 512, 612, 301, 901, 64, 704, 0]
    counts = [chunk_blocks] * 3 + [1] * 5
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    t = int(sum(counts)) * bq
    tables = np.zeros((len(q_lens), maxp), np.int32)
    nxt = 1
    for s, kl in enumerate(kv_lens):
        for j in range(-(-kl // ps)):
            tables[s, j] = 7 * num_pages + nxt
            nxt += 1
    pool = (hkv, layers * num_pages, ps, d)
    k_pages = torch.randn(pool, generator=gen, device="cuda", dtype=dtype)
    v_pages = torch.randn(pool, generator=gen, device="cuda", dtype=dtype)
    q = torch.randn((hq, t, d), generator=gen, device="cuda", dtype=dtype)
    as_i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device="cuda")  # noqa: E731
    desc = [as_i32(x) for x in (starts, counts, q_lens, kv_lens, tables)]
    es = q.element_size()
    pages_read = sum(-(-kl // ps) for kl in kv_lens)
    nbytes = 2 * q.numel() * es + 2 * pages_read * hkv * ps * d * es + sum(x.numel() * 4 for x in desc)
    keys = sum(kl - ql + r + 1 for ql, kl in zip(q_lens, kv_lens) for r in range(ql))
    flops = 4.0 * hq * d * keys
    return q, k_pages, v_pages, desc, dict(block_q=bq, max_q_blocks=chunk_blocks), nbytes, flops


def _flash_case(dtype, gen, s=931):
    b, hq, hkv, d = 1, 32, 8, 128
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    return q, k, v


def phase_kernels(timer: _Timer) -> dict:
    """Each kernel against its plain version on the same inputs. Returns the
    bf16 (serving dtype) numbers per kernel for the final line."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tol = {
        torch.bfloat16: (2e-2, 2e-2, "both sides compute in f32 from the same bf16 "
                         "inputs; summing in another order can move the final bf16 "
                         "rounding by one ulp (2^-7 at |x|~1)"),
        torch.float32: (1e-4, 1e-4, "f32 sums over up to 901 keys in another order"),
    }
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol, why = tol[dtype]
        name = str(dtype).replace("torch.", "")
        # ---- ragged paged attention
        q, kp, vp, desc, kw, nbytes, flops = _ragged_case(dtype, gen)
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
        q_scaled = (q.float() * sm_scale).to(dtype)
        out = ragged_paged_attention(q, kp, vp, *desc, **kw)
        ref = ragged_reference_attention(q_scaled, kp, vp, *desc, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
        ms = timer.ms(lambda: _ragged_cuda(q_scaled, kp, vp, *desc, **kw), 20)
        plain_ms = timer.ms(lambda: ragged_reference_attention(q_scaled, kp, vp, *desc, **kw), 3)
        bound, bound_by = _bound_ms(nbytes, flops, dtype)
        log("kernels", f"ragged_paged_attention {name}: max_abs_err={err:.3e} "
            f"atol={atol} rtol={rtol} ({why}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound:.4f} ({bound_by}) library_ms=null")
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"ragged kernel disagrees with its plain version ({name})")
        if dtype == torch.bfloat16:
            results["ragged_paged_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=None)
        del q, kp, vp, desc, out, ref, q_scaled
        torch.cuda.empty_cache()
        # ---- flash attention forward
        for causal in (True, False):
            q, k, v = _flash_case(dtype, gen)
            out, lse = flash_attention_with_lse(q, k, v, causal=causal)
            ref, ref_lse = _flash_fwd_plain(q, k, v, causal, 1.0 / np.sqrt(q.shape[-1]))
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = (torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
                  and torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-4))
            ms = timer.ms(lambda: flash_attention_with_lse(q, k, v, causal=causal), 10)
            plain_ms = timer.ms(
                lambda: _flash_fwd_plain(q, k, v, causal, 1.0 / np.sqrt(q.shape[-1])), 3)
            lib_ms = timer.ms(lambda: _sdpa(q, k, v, causal), 10)
            b, hq, s, d = q.shape
            es = q.element_size()
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * es + b * hq * s * 4
            pairs = s * (s + 1) / 2 if causal else s * s
            bound, bound_by = _bound_ms(nbytes, 4.0 * b * hq * d * pairs, dtype)
            log("kernels", f"flash_attention_fwd {name} causal={causal} S={s} GQA {hq}/{k.shape[1]}: "
                f"max_abs_err={err:.3e} lse_err={lse_err:.3e} atol={atol} rtol={rtol} "
                f"(lse 1e-4: f32 on both sides) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bound:.4f} ({bound_by}) library_ms={lib_ms:.4f}")
            if not ok or not torch.isfinite(out).all():
                raise AssertionError(f"flash kernel disagrees with its plain version ({name})")
            if dtype == torch.bfloat16 and causal:
                results["flash_attention_fwd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=bound_by, library_ms=lib_ms)
            del q, k, v, out, lse, ref, ref_lse
        # ---- the train path's shapes: flash forward and both backward kernels
        fwd_train = _fwd_train_shape(timer, dtype, gen, atol, rtol)
        for label, shape in BWD_SHAPES.items():
            bwd = _bwd_checks(timer, dtype, gen, label, shape, atol, rtol)
            if dtype == torch.bfloat16 and label == "gpt2":
                results.update(bwd)
        if dtype == torch.bfloat16:
            results["flash_attention_fwd"]["train_shape"] = fwd_train
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    log("kernels", f"done ({time.perf_counter() - t0:.2f} s)")
    return results


def _sdpa(q, k, v, causal):
    """One PyTorch call computing the flash function: the library yardstick,
    timed here and never called by the port."""
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    kx = torch.repeat_interleave(k, q.shape[1] // k.shape[1], dim=1)
    vx = torch.repeat_interleave(v, q.shape[1] // v.shape[1], dim=1)
    return F.scaled_dot_product_attention(q, kx, vx, is_causal=causal)


def _qkv_do(dtype, gen, shape):
    b, hq, hkv, s, d = shape
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    do = torch.randn((b, hq, s, d), generator=gen, device="cuda", dtype=dtype)
    return q, k, v, do


def _fwd_train_shape(timer, dtype, gen, atol, rtol) -> dict:
    """The flash forward kernel at the GPT-2 124M train shape, causal."""
    b, hq, hkv, s, d = BWD_SHAPES["gpt2"]
    q, k, v, _ = _qkv_do(dtype, gen, BWD_SHAPES["gpt2"])
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_attention_with_lse(q, k, v, causal=True)
    ref, ref_lse = _flash_fwd_plain(q, k, v, True, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = (torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
          and torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-4) and bool(torch.isfinite(out).all()))
    ms = timer.ms(lambda: flash_attention_with_lse(q, k, v, causal=True), 10)
    plain_ms = timer.ms(lambda: _flash_fwd_plain(q, k, v, True, scale), 3)
    lib_ms = timer.ms(lambda: _sdpa(q, k, v, True), 10)
    es = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * es + b * hq * s * 4
    bound, bound_by = _bound_ms(nbytes, 4.0 * b * hq * d * s * (s + 1) / 2, dtype)
    name = str(dtype).replace("torch.", "")
    log("kernels", f"flash_attention_fwd {name} causal=True train shape B={b} H={hq} S={s} D={d}: "
        f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} ({bound_by}) library_ms={lib_ms:.4f}")
    if not ok:
        raise AssertionError(f"flash forward disagrees with its plain version at the train shape ({name})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms)


def _bwd_costs(shape, es) -> dict:
    """(bytes, flops) of the causal backward: each kernel's own function
    (dK, dV need the S, dP, dV and dK products; dQ needs S, dP and dQ) and
    the whole function (5 products of 2 * D flops per unmasked pair; q, k,
    v, o, dO, dq, dk, dv, lse and delta each moved once)."""
    b, hq, hkv, s, d = shape
    pairs = b * hq * s * (s + 1) / 2
    q_bytes, kv_bytes, row_bytes = b * hq * s * d * es, b * hkv * s * d * es, b * hq * s * 4
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes  # q, dO, k, v, lse, delta
    return {
        "dkv": (reads + 2 * kv_bytes, 4 * 2.0 * d * pairs),
        "dq": (reads + q_bytes, 3 * 2.0 * d * pairs),
        "both": (reads + 2 * q_bytes + 2 * kv_bytes, 5 * 2.0 * d * pairs),
    }


def _bwd_launchers(q, k, v, out, lse, do, scale, dkv=FLASH_BWD_DKV.launch, dq=FLASH_BWD_DQ.launch):
    """Each backward kernel alone on the wrapper's inputs (for its own
    time); `dkv` and `dq` take the C launch functions' arguments. The last
    item keeps delta and the outputs (dq, dk, dv) alive."""
    b, hq, s, d = q.shape
    delta = _delta(do, out)
    dq_out, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tail = (_DTYPE_CODES[q.dtype], d, b, hq, k.shape[1], s, s, 1, float(scale * _LOG2E),
            float(scale), torch.cuda.current_stream().cuda_stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    keep = (delta, dq_out, dk, dv)
    return (lambda: dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail),
            lambda: dq(*ins, dq_out.data_ptr(), *tail), keep)


def _bwd_checks(timer, dtype, gen, label, shape, atol, rtol) -> dict:
    """Both backward kernels against _flash_bwd_plain on the forward
    kernel's own out and lse, causal, and against their own second run
    (bitwise: one owner block per output, no atomics); times of each
    kernel, of delta alone, of the whole wrapper (delta + both launches),
    of the plain version and of SDPA's backward through
    torch.autograd.grad."""
    b, hq, hkv, s, d = shape
    q, k, v, do = _qkv_do(dtype, gen, shape)
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_attention_with_lse(q, k, v, causal=True)
    grads = _flash_bwd_cuda(q, k, v, out, lse, do, True, scale)
    ref = _flash_bwd_plain(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    errs = {n: (g.float() - r.float()).abs().max().item() for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
    ok = all(torch.allclose(g.float(), r.float(), atol=atol, rtol=rtol) and bool(torch.isfinite(g).all())
             for g, r in zip(grads, ref))
    again = _flash_bwd_cuda(q, k, v, out, lse, do, True, scale)
    deterministic = all(torch.equal(a, g) for a, g in zip(again, grads))
    del grads, ref, again
    dkv_fn, dq_fn, keep = _bwd_launchers(q, k, v, out, lse, do, scale)
    ms_dkv = timer.ms(dkv_fn, 10)
    ms_dq = timer.ms(dq_fn, 10)
    ms_all = timer.ms(lambda: _flash_bwd_cuda(q, k, v, out, lse, do, True, scale), 10)
    ms_delta = timer.ms(lambda: _delta(do, out), 10)
    plain_ms = timer.ms(lambda: _flash_bwd_plain(q, k, v, out, lse, do, True, scale), 3)
    del keep
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o = _sdpa(qr, kr, vr, True)
    lib_ms = timer.ms(lambda: torch.autograd.grad(o, (qr, kr, vr), do, retain_graph=True), 10)
    del o, qr, kr, vr
    bounds = {n: _bound_ms(nb, fl, dtype) for n, (nb, fl) in _bwd_costs(shape, q.element_size()).items()}
    name = str(dtype).replace("torch.", "")
    log("kernels", f"flash_attention_bwd {name} causal=True {label} B={b} GQA {hq}/{hkv} S={s} D={d}: "
        f"max_abs_err dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e} "
        f"atol={atol} rtol={rtol} (P and dS rounded to the input dtype at the same places on "
        f"both sides; exp2 and f32 sums may differ in the last bit, which can move one bf16 "
        f"rounding by an ulp) dkv_ms={ms_dkv:.4f} (bound {bounds['dkv'][0]:.4f} "
        f"{bounds['dkv'][1]}) dq_ms={ms_dq:.4f} (bound {bounds['dq'][0]:.4f} {bounds['dq'][1]}) "
        f"wrapper_ms={ms_all:.4f} (bound {bounds['both'][0]:.4f} {bounds['both'][1]}) "
        f"delta_ms={ms_delta:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA backward) "
        f"deterministic={deterministic}")
    if not ok:
        raise AssertionError(f"flash backward kernels disagree with their plain version ({name} {label})")
    if not deterministic:
        raise AssertionError(f"flash backward kernels: two runs differ ({name} {label})")
    common = dict(plain_ms=plain_ms, library_ms=lib_ms, wrapper_ms=ms_all, delta_ms=ms_delta)
    return {
        "flash_attention_bwd_dkv": dict(max_abs_err=max(errs["dk"], errs["dv"]), ms=ms_dkv,
                                        bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1], **common),
        "flash_attention_bwd_dq": dict(max_abs_err=errs["dq"], ms=ms_dq, bound_ms=bounds["dq"][0],
                                       bound_by=bounds["dq"][1], **common),
    }


def phase_serve():
    t0 = time.perf_counter()
    config = get_config(MODEL).replace(param_dtype=torch.bfloat16)
    server = LLMServer(
        config, engine_config=PagedEngineConfig(max_slots=N_REQUESTS, paged=PagedConfig()),
        seed=SEED, device="cuda",
    )
    torch.cuda.synchronize()
    log("serve", f"{MODEL}: {config.n_layers} layers d_model {config.d_model} "
        f"heads {config.n_heads}/{config.kv_heads} vocab {config.vocab_size}, bf16 "
        f"weights from seed {SEED} ({time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    rng = np.random.default_rng(SEED)
    # one short request first: cuBLAS handles and allocator warm-up
    server.generate({"prompt_tokens": [1] * 64, "max_tokens": 2})
    lengths = np.linspace(64, 900, N_REQUESTS).astype(int)
    prompts = [rng.integers(0, config.vocab_size, n).tolist() for n in lengths]
    stats0 = server.engine.stats()
    for kernel in KERNELS:
        kernel.launches = 0
    stamps = [[] for _ in prompts]
    t_start = time.perf_counter()
    streams = [server.engine.submit(p, max_tokens=MAX_TOKENS) for p in prompts]

    def consume(i):
        for token in streams[i]:
            stamps[i].append((time.perf_counter(), token))

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(streams))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise RuntimeError("a request did not finish within 600 s")
    wall = time.perf_counter() - t_start
    outs = [[tok for _, tok in st] for st in stamps]
    for out in outs:
        if len(out) != MAX_TOKENS or not all(0 <= t < config.vocab_size for t in out):
            raise AssertionError(f"bad completion: {len(out)} tokens")
    ttft = [st[0][0] - t_start for st in stamps]
    first_all = min(st[0][0] for st in stamps)
    last_all = max(st[-1][0] for st in stamps)
    decode_tokens = sum(len(st) - 1 for st in stamps)
    stats = {k: v - stats0[k] for k, v in server.engine.stats().items()}
    log("serve", f"{N_REQUESTS} requests, prompts {lengths.min()}-{lengths.max()} tokens, "
        f"{MAX_TOKENS} new each: wall {wall:.3f} s, TTFT p50 {statistics.median(ttft):.3f} s "
        f"max {max(ttft):.3f} s, decode {decode_tokens / (last_all - first_all):.1f} tok/s "
        f"(tokens after each request's first, over first-token-to-last-token), "
        f"output {N_REQUESTS * MAX_TOKENS / wall:.1f} tok/s over the wall, mixed ticks "
        f"{stats['mixed_ticks']:.0f}, decode blocks {stats['decode_blocks']:.0f}, "
        f"ragged launches {RAGGED.launches}")
    if RAGGED.launches == 0:
        raise AssertionError("the serving path never launched the ragged kernel")
    return server, config, prompts, outs


def phase_check(server, config, prompts, outs) -> None:
    """Teacher-forced dense forward (flash kernel) over prompt + generated
    tokens: the engine's token at each generated position must score within
    CHECK_MARGIN of the dense argmax. Both paths compute in bf16 but round
    at different places (ragged attention keeps p in f32, flash rounds p to
    bf16; products of other shapes sum in other orders), so near-ties may
    flip; the margin is a few bf16 ulps of logits of this size (~0.03-0.06
    at |logit| 4-8), with room for that drift through 32 layers."""
    t0 = time.perf_counter()
    before = FLASH_FWD.launches
    picks = [0, len(prompts) - 1]
    worst, exact, total = 0.0, 0, 0
    with torch.no_grad():
        for i in picks:
            seq = prompts[i] + outs[i]
            tokens = torch.tensor([seq[:-1]], device="cuda")
            logits = forward(server.engine.params, tokens, config)[0].float()
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite dense logits")
            rows = logits[len(prompts[i]) - 1:]
            chosen = torch.tensor(outs[i], device="cuda")
            gap = rows.max(dim=-1).values - rows.gather(1, chosen[:, None])[:, 0]
            worst = max(worst, gap.max().item())
            exact += int((rows.argmax(dim=-1) == chosen).sum())
            total += len(outs[i])
    launched = FLASH_FWD.launches - before
    log("check", f"margin {CHECK_MARGIN}: bf16 logits, ragged f32-p vs flash bf16-p "
        f"attention and other product shapes round differently")
    log("check", f"{len(picks)} requests, {total} generated positions: engine token == dense "
        f"argmax at {exact}, worst gap {worst:.4f}, flash launches {launched} "
        f"({time.perf_counter() - t0:.2f} s)")
    if launched == 0:
        raise AssertionError("the dense check never launched the flash kernel")
    if worst > CHECK_MARGIN:
        raise AssertionError(f"engine token scores {worst:.4f} below the dense argmax")


def _leaf_names(tree, prefix=""):
    """Names of the leaves in `tree_leaves` order."""
    names = []
    for key, value in tree.items():
        if isinstance(value, dict):
            names.extend(_leaf_names(value, f"{prefix}{key}."))
        else:
            names.append(prefix + key)
    return names


def _grad_check(config, params, tokens) -> None:
    """The kernel path's gradients against attn_impl="xla" (mha_reference
    under torch autograd) on the card, same params and tokens, bf16
    compute. Tolerances (GRAD_TOL_*): the two paths round differently — the
    kernels keep P in f32 until the bf16 cast before P.V and sum every
    product in f32, while the reference's attention products run as bf16
    cuBLAS calls with bf16 outputs, forward and backward — so each
    attention output and gradient differs by up to a bf16 ulp (2^-8
    relative), and that passes through 12 layers of the backward. Leaves
    that hold under 1e-3 of the global norm (bk, whose exact gradient is 0:
    a per-row constant shift of the scores) are held only through the
    global difference."""
    t0 = time.perf_counter()
    loss_k, _, g_k = loss_and_grads(config, params, tokens, loss_chunk=0)
    before = FLASH_BWD_DQ.launches
    loss_x, _, g_x = loss_and_grads(config.replace(attn_impl="xla"), params, tokens, loss_chunk=0)
    if FLASH_BWD_DQ.launches != before:
        raise AssertionError("the xla reference path launched a flash kernel")
    norm_k, norm_x = global_norm(g_k).item(), global_norm(g_x).item()
    diff = global_norm([a - b for a, b in zip(g_k, g_x)]).item() / norm_x
    leaf = []
    for name, a, b in zip(_leaf_names(params), g_k, g_x):
        nb = b.float().norm().item()
        if nb >= 1e-3 * norm_x:
            leaf.append(((a - b).float().norm().item() / nb, name))
    worst, worst_name = max(leaf)
    rel_norm = abs(norm_k - norm_x) / norm_x
    log("train", f"grad check, batch {tokens.shape[0]} x {tokens.shape[1] - 1}: loss kernel "
        f"{loss_k.item():.6f} xla {loss_x.item():.6f}; global norm kernel {norm_k:.6f} xla "
        f"{norm_x:.6f} (rel {rel_norm:.3e}, tol {GRAD_TOL_NORM}); ||g_kernel - g_xla|| / ||g_xla|| "
        f"{diff:.3e} (tol {GRAD_TOL_DIFF}); worst leaf {worst_name} {worst:.3e} (tol "
        f"{GRAD_TOL_LEAF}, {len(leaf)} of {len(g_k)} leaves hold >= 1e-3 of the norm) "
        f"({time.perf_counter() - t0:.2f} s)")
    log("train", "per-leaf relative difference: " + ", ".join(f"{n} {e:.2e}" for e, n in sorted(leaf, reverse=True)))
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    if not finite or rel_norm > GRAD_TOL_NORM or diff > GRAD_TOL_DIFF or worst > GRAD_TOL_LEAF:
        raise AssertionError("kernel-path gradients disagree with the xla reference path")


def phase_train() -> dict:
    """GPT-2 124M through make_train_step on the card; returns each
    kernel's launches over the timed steps (counted from zero just before
    them)."""
    t0 = time.perf_counter()
    config = get_config(TRAIN_MODEL)
    opt = default_optimizer(TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS)
    state = create_train_state(config, opt, SEED, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    tokens = torch.randint(0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen,
                           device="cuda")
    log("train", f"{TRAIN_MODEL}: {count_params(state.params)} params (f32 masters), "
        f"{config.n_layers} layers d_model {config.d_model} heads {config.n_heads} vocab "
        f"{config.vocab_size}, compute {str(config.dtype).replace('torch.', '')}, remat "
        f"{config.remat}, seed {SEED} ({time.perf_counter() - t0:.2f} s)")
    _grad_check(config, state.params, tokens[:GRAD_CHECK_BATCH, :GRAD_CHECK_SEQ + 1])
    step = make_train_step(config, opt, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in KERNELS:
        kernel.launches = 0
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append(m)
    launches = {k.name: k.launches for k in KERNELS}
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    step_s = statistics.median(times[TRAIN_WARMUP:])
    ntok = TRAIN_BATCH * TRAIN_SEQ
    log("train", f"{TRAIN_STEPS} steps on one fixed {TRAIN_BATCH} x {TRAIN_SEQ + 1} batch, "
        f"lr {TRAIN_LR} (warmup 2, cosine to 0.1x): step median {step_s * 1e3:.2f} ms "
        f"(min {min(times[TRAIN_WARMUP:]) * 1e3:.2f}, max {max(times[TRAIN_WARMUP:]) * 1e3:.2f}; "
        f"first {times[0] * 1e3:.2f}) over steps {TRAIN_WARMUP + 1}-{TRAIN_STEPS}, "
        f"{ntok / step_s:.1f} tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("train", "loss " + " ".join(f"{x:.4f}" for x in losses))
    log("train", "grad_norm " + " ".join(f"{x:.4f}" for x in gnorms))
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    log("train", f"launches per step {per_step} (each backward kernel must show "
        f"{config.n_layers}: one per layer) ({time.perf_counter() - t0:.2f} s)")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    if not losses[-1] < LOSS_MARGIN * losses[0]:
        raise AssertionError(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}: not below "
                             f"{LOSS_MARGIN} x the first")
    for kernel in (FLASH_BWD_DKV, FLASH_BWD_DQ):
        if launches[kernel.name] != config.n_layers * TRAIN_STEPS:
            raise AssertionError(f"{kernel.name}: {launches[kernel.name]} launches in "
                                 f"{TRAIN_STEPS} steps, want {config.n_layers} per step")
    if launches[FLASH_FWD.name] == 0:
        raise AssertionError("the train path never launched the flash forward kernel")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_env()
    phase_build()
    timer = _Timer()
    results = phase_kernels(timer)
    del timer
    torch.cuda.empty_cache()
    server, config, prompts, outs = phase_serve()
    try:
        phase_check(server, config, prompts, outs)
    finally:
        server.shutdown()
    serve_launches = {k.name: k.launches for k in KERNELS}
    del server
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = phase_train()
    kernels = []
    for k in KERNELS:
        by_path = {"serve": serve_launches[k.name], "train": train_launches[k.name]}
        kernels.append(dict(
            name=k.name, route="cuda", source=SOURCES[k.name], replaces=REPLACES[k.name],
            launches=sum(by_path.values()), launches_by_path=by_path, **results[k.name]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
