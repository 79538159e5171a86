#!/usr/bin/env python3
"""Drive the ray_tpu_torch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases (one line each, timed; any failure raises, so the exit code is
nonzero and no result line is printed):

1. env     — torch / CUDA / nvcc versions, the card's name and power limit.
2. build   — nvcc builds every kernel under ray_tpu_torch/ops/csrc/ (one
             process per source, started together).
3. kernels — each kernel against its plain PyTorch version at the Llama-3-8B
             shapes of the serving path, in bf16 and f32, with times, the
             card's bound and (flash) the PyTorch library yardstick.
4. serve   — LLMServer("llama3-8b") at full width and depth on the card,
             random bf16 weights from a seeded torch.Generator, 8 greedy
             requests with prompts of 64-900 tokens, 32 new tokens each.
5. check   — the dense forward (flash kernel) over prompt + generated tokens
             of 2 requests: every engine token must score within a stated
             margin of the dense argmax.

The line before the last lists every kernel with its launches on the main
path (phases 4-5), its error against the plain version and its times; the
last line is {"ok": true, "device": {...}}. Needs one CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import forward, get_config
from ray_tpu_torch.ops import FLASH_FWD, KERNELS, RAGGED, ragged_paged_attention
from ray_tpu_torch.ops._build import build_all
from ray_tpu_torch.ops.attention import _flash_fwd_plain, flash_attention_with_lse
from ray_tpu_torch.ops.ragged_paged_attention import _ragged_cuda, ragged_reference_attention
from ray_tpu_torch.serve.llm import LLMServer, PagedConfig, PagedEngineConfig

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 FMA
SEED = 0
MODEL = "llama3-8b"
N_REQUESTS = 8
MAX_TOKENS = 32
CHECK_MARGIN = 0.25
REPLACES = {
    "ragged_paged_attention": "ray_tpu/ops/ragged_paged_attention.py:60",
    "flash_attention_fwd": "ray_tpu/ops/attention.py:83",
}
SOURCES = {
    "ragged_paged_attention": "ray_tpu_torch/ops/csrc/ragged_paged_attention.cu",
    "flash_attention_fwd": "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


# ----------------------------------------------------------------- timing


class _Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the serving path reads different pages every layer, so a warm
    50 MB L2 would flatter the kernels)."""

    def __init__(self):
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
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
            if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=causal, enable_gqa=True)
            else:
                kx = torch.repeat_interleave(k, q.shape[1] // k.shape[1], dim=1)
                vx = torch.repeat_interleave(v, q.shape[1] // v.shape[1], dim=1)
                lib = lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=causal)  # noqa: E731
            lib_ms = timer.ms(lib, 10)
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
    torch.cuda.empty_cache()
    log("kernels", f"done ({time.perf_counter() - t0:.2f} s)")
    return results


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
    kernels = []
    for k in KERNELS:
        kernels.append(dict(
            name=k.name, route="cuda", source=SOURCES[k.name], replaces=REPLACES[k.name],
            launches=k.launches, **results[k.name]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
