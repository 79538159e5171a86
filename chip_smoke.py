#!/usr/bin/env python3
"""Drive the ray_tpu_torch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases (one line each, timed; any failure raises, so the exit code is
nonzero and no result line is printed):

1. env     — torch / CUDA / nvcc versions, the card's name and power limit.
2. build   — nvcc builds every kernel under ray_tpu_torch/ops/csrc/ (one
             process per source, started together); `cuobjdump -sass`
             counts the wgmma (HGMMA) and asynchronous copies (LDGSTS,
             UTMALDG) of each instance of the flash forward and backward
             kernels and of the ragged kernels: a bf16 flash instance
             without HGMMA, a bf16 ragged main kernel (tile or split
             decode) without HGMMA or without asynchronous copies, or an
             f32 instance with HGMMA fails the phase.
3. kernels — each kernel against its plain PyTorch version, in bf16 and
             f32, with times, the card's bound and (flash) the PyTorch
             library yardstick: ragged at the Llama-3-8B shapes of the
             serving path, a mixed tick's batch, a decode step's and a
             decode-only verify tick's (each also bitwise against a second
             run, and against the kernel on q scaled beforehand; where the
             largest error sits, and the device kernels one call runs,
             read from torch.profiler); the flash forward and both flash
             backward kernels at the Llama shape of the dense check (GQA
             32/8, S 931, D 128; the forward causal and not) and at the
             GPT-2 124M shape of the train path (B 8, 12 heads, S 1024,
             D 64), the forward also at the draft model's (S 64) and at
             the dense engine's prefill buckets (S 16, 32, 1024). Two runs must be bitwise equal; the bare launches are timed
             apart from the wrappers (the forward's on contiguous tensors
             and on the model's transposed views, which it copies; the
             backward's with delta = rowsum(dO * O)).
4. serve   — LLMServer("llama3-8b") at full width and depth on the card,
             random bf16 weights from a seeded torch.Generator, the
             engine's passes captured as CUDA graphs up front (precompile:
             capture time, graph count, memory after capture); 8 greedy
             requests with prompts of 64-900 tokens, 32 new tokens each,
             unprofiled (wall, TTFT, decode rate). A replay passes through
             no kernel wrapper: the engine counts each pass's replays times
             the launches its capture recorded, by kind (decode steps, mixed
             ticks), each kind must occur and no ragged launch may pass
             through the wrapper. A profiled repeat of the 8 requests must
             show torch.profiler's ragged device kernels equal to the
             engine's count for it (the profiler may drop records of graph
             kernels, never add any: up to 3 repeats, each printed, the
             first that equals passes); one request at temperature 1, top-k 50
             (the filtered decode graph) must stay in the vocabulary and
             differ from its greedy twin.
5. check   — the dense forward (flash kernel) over prompt + generated tokens
             of 2 requests: every engine token must score within a stated
             margin of the dense argmax.
   spec    — speculative decoding and the prefix cache on the serve phase's
             weight tensors (K = 4, verify passes captured as CUDA graphs):
             a replay drill (drafts: the serve phase's greedy tokens;
             prefix cache on) that must run verify rounds and accept
             drafts; 8 prompts sharing a 512-token prefix, of which at
             least 7 must hit the cache (TTFT against the serve engine);
             a self-replay on a second engine (drafts: the drill's own
             tokens); a draft model (a 2-layer cut of the model) that must
             propose and launch the flash kernel. Each run passes the
             dense check; the drill's and the self-replay's ragged
             launches are held against torch.profiler; replay times of the
             serve and verify graphs and of the accept step are printed.
   dense   — LLMServer(engine_config=None) on the serve phase's weight
             tensors builds the dense LLMEngine (8 slots, max_seq 1024, its
             decode step one CUDA graph): the serve phase's 8 greedy
             requests (TTFT, decode rate, wall, capture time and memory);
             flash launches of its eager prefills counted by the engine
             (prefills x layers) and held against the wrapper's count and
             torch.profiler's; every request passes the dense check; one
             decode-graph replay equals eager decode_step bitwise.
   overload — a PagedLLMEngine (4 slots, a pool the 4 long lanes nearly
             fill, graphs captured up front) on the same weights: 4
             priority-0 lanes (512-token prompts, 256 new tokens) decode
             when 2 priority-1 requests arrive and preempt lanes, which park
             and resume (preemptions, pages, resumes, stalls, the priority-1
             TTFT against the same run with preemption off, and the pair
             again on an engine with 1 block in flight); then a burst
             of 3 x the queue bound (typed sheds), a tenant over its quota
             (typed sheds with a finite retry_after_s) and requests with
             0.2 s deadlines behind long lanes (typed timeouts at the admit
             pop and mid-decode). Every stream ends with tokens or a typed
             error, the pool returns to full, every finished stream passes
             the dense check, and the ragged launches counted by the engine
             are held against torch.profiler's.
6. train   — GPT-2 124M (gpt2-small) at full width and depth, f32 master
             weights from a seeded torch.Generator, bf16 compute:
             the kernel path's gradients against attn_impl="xla" on one
             smaller batch, then TRAIN_STEPS steps of make_train_step on one
             fixed 8 x 1025 batch; the loss must fall by the stated margin
             and each flash kernel must launch once per layer per step.
7. trainer — LMTrainer on gpt2-small at full width and depth (the train
             phase's optimizer: lr 1e-3, warmup 2, 20 steps) fed by
             lm_batch_iterator (pinned copies on a side stream, a prefetch
             window of 2) over a token stream made with numpy from the
             seed: the same 8 x 1025 window every step, as the train
             phase's fixed batch, so its loss margin holds. 20 steps,
             reports every 5, the step log sampling every 5th step,
             asynchronous checkpoints every 10 into a temporary directory.
             Per report: tokens/s, step_time_s, mfu, step_flops,
             step_bytes, roofline_hbm; each sampled step's buckets; the
             device time between consecutive steps' ends (CUDA events, no
             synchronisation); a checkpoint drill (snapshot, write and
             verified restore: seconds and bytes). Checks: the loss below
             LOSS_MARGIN x the first, 12 launches of each flash kernel a
             step, every sampled step's buckets summing to its wall_s,
             0 < mfu < 1 in every report, a second trainer's
             maybe_restore() at 20 with params and moments equal bitwise,
             and a trainer restored at step 10 reproducing steps 11-15's
             losses (bitwise).

The line before the last lists every kernel with its launches on the main
paths (serve: phases 4-5; spec; dense; overload; train: phase 6;
trainer: phase 7's 20-step run; each counted from zero just before it,
profiled repeats left out), its
error against the plain version and its times; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

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
    _flash_fwd_cuda,
    _flash_fwd_plain,
    flash_attention_with_lse,
)
from ray_tpu_torch.ops.ragged_paged_attention import (
    LAUNCHES_BY_KIND,
    _ragged_cuda,
    ragged_reference_attention,
)
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.exceptions import BackPressureError, RequestTimeoutError
from ray_tpu_torch.models.transformer import decode_step
from ray_tpu_torch.serve import tenancy
from ray_tpu_torch.serve.llm import (
    EngineConfig,
    LLMEngine,
    LLMServer,
    PagedConfig,
    PagedEngineConfig,
    PagedLLMEngine,
)
from ray_tpu_torch.serve.llm.speculative import (
    DraftModelProposer,
    ReplayProposer,
    accept_speculative,
)
from ray_tpu_torch.data import lm_batch_iterator
from ray_tpu_torch.train import (
    CheckpointConfig,
    CheckpointManager,
    LMTrainer,
    create_train_state,
    default_optimizer,
    global_norm,
    loss_and_grads,
    make_train_step,
    steplog,
    tree_leaves,
)

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 FMA
SEED = 0
MODEL = "llama3-8b"
N_REQUESTS = 8
MAX_TOKENS = 32
CHECK_MARGIN = 0.25
# The overload phase checks every position of every stream it finished
# (~5000; phase_check checks 64). Over that many positions the serve path's
# own bf16 tail passes 0.25: the untouched serve engine's greedy tokens reach
# 0.3125 below the dense argmax at 1 of 960 positions, and 0.25 with the
# ragged kernels' plain version, p in f32 (torch_check_tail.py). 0.5 is 16
# bf16 ulps at |logit| 4-8; a corrupt KV or a wrong resume puts tokens
# whole units below. Positions over CHECK_MARGIN are counted and printed.
OVERLOAD_CHECK_MARGIN = 2 * CHECK_MARGIN
PROFILED_REPEATS = 3  # serve: profiled repeats to find one without dropped records
SPEC_TOKENS = 4  # drafts per verify round in the spec phase
PREFIX_TOKENS = 512  # the spec phase's shared prefix: 8 pages of 64
DRAFT_LAYERS, DRAFT_WINDOW = 2, 64  # the draft model: a 2-layer cut of the target
DENSE_MAX_SEQ = 1024  # the dense engine's cache per slot: the serve prompts + 32 new fit
OVERLOAD_SLOTS = 4
OVERLOAD_LOW_TOKENS, OVERLOAD_HIGH_TOKENS = 256, 32
# 4 lanes of 512 + 256 tokens hold 12 pages of 64 each at the end: 48 of the
# 50 allocatable; a resumed lane's chunk-aligned re-prefill needs at most 12
OVERLOAD_PAGES = 51
DEADLINE_S = 0.2
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
TRAINER_CKPT_EVERY = 10
TRAINER_REPORT_EVERY = 5
TRAINER_SAMPLE_EVERY = 5
TRAINER_RESUME_FROM, TRAINER_RESUME_STEPS = 10, 5  # a restored trainer redoes steps 11-15
# kernel path vs attn_impl="xla" gradients in bf16 compute (see _grad_check)
GRAD_TOL_NORM = 0.01  # relative difference of the global norms
GRAD_TOL_DIFF = 0.05  # ||g_kernel - g_xla|| / ||g_xla|| over all leaves
GRAD_TOL_LEAF = 0.10  # the same per leaf, for leaves that hold >= 1e-3 of the norm
FLASH_SHAPES = {  # (B, Hq, Hkv, S, D)
    "gpt2": (TRAIN_BATCH, 12, 12, TRAIN_SEQ, 64),
    "llama": (1, 32, 8, 931, 128),
    "draft": (1, 32, 8, 64, 128),  # the spec phase's draft-model prefill (window 64)
    # the dense engine's prefill buckets: 16 and 32 rows are under one tile
    "bucket16": (1, 32, 8, 16, 128),
    "bucket32": (1, 32, 8, 32, 128),
    "bucket1024": (1, 32, 8, 1024, 128),
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
    _check_sass()


SASS_OPS = ("HGMMA", "LDGSTS", "UTMALDG")


def _kernel_name(fn: str) -> str:
    """flash_fwd_wgmmaILi64E -> flash_fwd_wgmma<64>, ragged_wgmmaILi128ELb1E ->
    ragged_wgmma<128,1> (demangled template arguments, ints and bools). The
    kernel's name is the flash_ / ragged_ identifier whose mangled length
    prefix matches it (the anonymous namespace's own name holds the file's)."""
    for m in re.finditer(r"(\d+)((?:flash|ragged)_[A-Za-z0-9_]+?)I", fn):
        digits, name = m.group(1), m.group(2)
        for k in range(len(digits)):  # the length prefix is the digits' tail
            if int(digits[k:]) == len(name) and digits[k] != "0":
                args = fn[m.end():].split("EEEv", 1)[0]
                vals = re.findall(r"L[a-z](\d+)", args)
                return name + (f"<{','.join(vals)}>" if vals else "")
    return fn


def _check_sass() -> None:
    """wgmma and asynchronous copies in the SASS of each instance of the
    flash forward and backward kernels and of the ragged kernels. The bf16
    instances of the main paths must run their products on wgmma, and the
    bf16 ragged main kernels (the tile kernel and the split decode walk,
    `ragged_wgmma<D,split>`) must also load through asynchronous copies;
    the f32 instances must not use wgmma (TF32). The ragged combine pass
    reads each f32 partial once and has nothing to overlap: its counts are
    printed, not held."""
    wrong = []
    for kernel in (FLASH_FWD, FLASH_BWD_DKV, RAGGED):  # one kernel per source
        for fn, counts in sass_counts(kernel, SASS_OPS).items():
            kind = "bf16" if "bfloat16" in fn else "f32"
            name = _kernel_name(fn)
            log("build", f"sass {name} ({kind}): " + " ".join(f"{op}={n}" for op, n in counts.items()))
            if "combine" in name:
                continue
            copies = counts["LDGSTS"] + counts["UTMALDG"]
            if (kind == "bf16") != (counts["HGMMA"] > 0) or (
                    kind == "bf16" and name.startswith("ragged") and copies == 0):
                wrong.append(name)
    if wrong:
        raise AssertionError("bf16 instances without wgmma (HGMMA) or, ragged, without "
                             f"asynchronous copies; or f32 ones with wgmma: {wrong}")


def _ragged_case(dtype, gen):
    """A mixed batch at the serving path's Llama-3-8B shapes: prefill chunks
    (one fresh, one at offset 256, one partial at offset 512), decode lanes
    (one on a page boundary), a verify-shaped region (q_len 4) and an
    inactive lane, against the full 32-layer flat pool with layer 7's page
    offset folded into the tables. Unused table entries are scratch page 0."""
    chunk_blocks = 256 // 8
    return _ragged_batch(dtype, gen, q_lens=[256, 256, 100, 1, 1, 1, 4, 0],
                         kv_lens=[256, 512, 612, 301, 901, 64, 704, 0],
                         counts=[chunk_blocks] * 3 + [1] * 5, max_q_blocks=chunk_blocks)


def _ragged_decode_case(dtype, gen):
    """A decode step of the serve run (89% of its ragged launches): 8 lanes
    of q_len 1 at the serve prompts' lengths + 16 (mid-way through the
    first K = 16 decode block), block_q 8, max_q_blocks 1, as
    `paged_attention` dispatches it."""
    return _ragged_batch(dtype, gen, q_lens=[1] * 8,
                         kv_lens=[80, 199, 318, 438, 557, 677, 796, 916],
                         counts=[1] * 8, max_q_blocks=1)


def _ragged_verify_case(dtype, gen):
    """A decode-only verify tick of the spec phase: bucket 1's inactive
    256-row prefill lane and 8 lanes of q_len 5 (the pending token and 4
    drafts) at the serve prompts' lengths + 16, max_q_blocks 32: the tile
    kernel, as `ragged_mixed_step` dispatches a verify pass."""
    return _ragged_batch(dtype, gen, q_lens=[0] + [5] * 8,
                         kv_lens=[0, 85, 204, 323, 443, 562, 682, 801, 921],
                         counts=[256 // 8] + [1] * 8, max_q_blocks=256 // 8)


def _ragged_batch(dtype, gen, q_lens, kv_lens, counts, max_q_blocks):
    """Inputs of one ragged call against the full 32-layer Llama-3-8B pool
    (layer 7's page offset folded into the tables), with the bytes it must
    move (q's real rows, every output row of the regions, the pages of each
    lane's walk, the descriptors; q's padding rows are left out, since no
    output depends on them) and the flops of its unmasked (query, key)
    pairs."""
    hq, hkv, d, ps, maxp, bq, num_pages, layers = 32, 8, 128, 64, 16, 8, 256, 32
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
    q_bytes = sum(q_lens) * hq * d * es
    nbytes = q_bytes + q.numel() * es + 2 * pages_read * hkv * ps * d * es + sum(x.numel() * 4 for x in desc)
    keys = sum(kl - ql + r + 1 for ql, kl in zip(q_lens, kv_lens) for r in range(ql))
    flops = 4.0 * hq * d * keys
    return q, k_pages, v_pages, desc, dict(block_q=bq, max_q_blocks=max_q_blocks), nbytes, flops


def phase_kernels(timer: _Timer) -> dict:
    """Each kernel against its plain version on the same inputs. Returns the
    bf16 (serving dtype) numbers per kernel for the final line."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tol = {
        torch.bfloat16: (2e-2, 2e-2, "the bf16 kernels round p to bf16 before P.V (the "
                         "flash kernels too), the plain versions keep p in f32: a relative "
                         "error of up to 2^-9 in each weight, which with f32 sums in another "
                         "order moves an output by up to about one bf16 ulp (2^-6 at "
                         "|x| in [2, 4)) against atol + rtol |x|"),
        torch.float32: (1e-4, 1e-4, "f32 sums over up to 901 keys in another order"),
    }
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol, why = tol[dtype]
        # ---- ragged paged attention: a mixed tick's batch, a decode
        # step's, a decode-only verify tick's
        ragged = {label: _ragged_checks(timer, dtype, gen, label, make, atol, rtol, why)
                  for label, make in (("mixed", _ragged_case), ("decode", _ragged_decode_case),
                                      ("verify", _ragged_verify_case))}
        if dtype == torch.bfloat16:
            results["ragged_paged_attention"] = dict(
                ragged["mixed"], **{f"{label}_{k}": v for label in ("decode", "verify")
                                    for k, v in ragged[label].items()})
        torch.cuda.empty_cache()
        # ---- flash forward and both backward kernels, at the dense check's
        # shape and at the train path's
        fwd = {(label, causal): _fwd_checks(timer, dtype, gen, label, causal, atol, rtol)
               for label, causal in (("llama", True), ("llama", False), ("gpt2", True),
                                     ("draft", True), ("bucket16", True), ("bucket32", True),
                                     ("bucket1024", True))}
        for label in ("gpt2", "llama"):
            bwd = _bwd_checks(timer, dtype, gen, label, FLASH_SHAPES[label], atol, rtol)
            if dtype == torch.bfloat16 and label == "gpt2":
                results.update(bwd)
        if dtype == torch.bfloat16:
            results["flash_attention_fwd"] = dict(
                fwd["llama", True], train_shape=fwd["gpt2", True], draft_shape=fwd["draft", True],
                **{f"dense_prefill_{label}": fwd[label, True]
                   for label in ("bucket16", "bucket32", "bucket1024")})
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    log("kernels", f"done ({time.perf_counter() - t0:.2f} s)")
    return results


def _ragged_checks(timer, dtype, gen, label, make, atol, rtol, why) -> dict:
    """The ragged kernels on one batch against ragged_reference_attention
    (on q scaled and rounded beforehand, as the dispatcher does for the
    plain version), with where the largest error sits (`_ragged_worst`),
    against their own second run (bitwise: each output row has one owner,
    the split partials combine in a fixed order) and against the kernels
    on the pre-scaled q with scale 1 (bitwise: the kernels' own scaling of
    q rounds exactly as the dispatcher's); times of the wrapper
    (`_ragged_cuda`: the zeroed output, the workspace, the kernels) and of
    the plain version; the ragged device kernels one call runs, read from
    the profiler."""
    q, kp, vp, desc, kw, nbytes, flops = make(dtype, gen)
    sm_scale = 1.0 / np.sqrt(q.shape[-1])
    q_scaled = (q.float() * sm_scale).to(dtype)
    out = ragged_paged_attention(q, kp, vp, *desc, **kw)
    again = _ragged_cuda(q, kp, vp, *desc, sm_scale=sm_scale, **kw)
    prescaled = _ragged_cuda(q_scaled, kp, vp, *desc, sm_scale=1.0, **kw)
    ref = ragged_reference_attention(q_scaled, kp, vp, *desc, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol) and bool(torch.isfinite(out).all())
    worst = _ragged_worst(out, ref, desc, kw["block_q"], atol, rtol)
    deterministic, same_scaling = torch.equal(out, again), torch.equal(out, prescaled)
    del again, prescaled, ref
    ms = timer.ms(lambda: _ragged_cuda(q, kp, vp, *desc, sm_scale=sm_scale, **kw), 20)
    plain_ms = timer.ms(lambda: ragged_reference_attention(q_scaled, kp, vp, *desc, **kw), 3)
    bound, bound_by = _bound_ms(nbytes, flops, dtype)
    per_call = _device_kernels(lambda: _ragged_cuda(q, kp, vp, *desc, sm_scale=sm_scale, **kw))
    name = str(dtype).replace("torch.", "")
    log("kernels", f"ragged_paged_attention {name} {label} (S={desc[0].numel()} "
        f"max_q_blocks={kw['max_q_blocks']}; device kernels a call: {', '.join(per_call)}): "
        f"max_abs_err={err:.3e} atol={atol} rtol={rtol} ({why}) kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({bound_by}, {nbytes} bytes) library_ms=null "
        f"deterministic={deterministic} scaled_in_kernel_bitwise={same_scaling}")
    log("kernels", f"ragged_paged_attention {name} {label} largest errors: {worst}")
    if not ok:
        raise AssertionError(f"ragged kernels disagree with their plain version ({name} {label})")
    if not deterministic:
        raise AssertionError(f"ragged kernels: two runs differ ({name} {label})")
    if not same_scaling:
        raise AssertionError(f"ragged kernels: q scaled in the kernel differs from q scaled "
                             f"beforehand ({name} {label})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None, device_kernels_per_call=len(per_call))


def _ragged_worst(out, ref, desc, block_q, atol, rtol) -> str:
    """The largest error over the real rows and over the padding rows of
    the regions: its place (head, lane, region row, column), |ref| there,
    and the largest ratio of error to allclose's allowance atol + rtol
    |ref| (1 would fail)."""
    starts, counts, q_lens = (x.tolist() for x in desc[:3])
    t = out.shape[1]
    lane_of = np.full(t, -1)
    row_of = np.zeros(t, np.int64)
    for s, (st, ct) in enumerate(zip(starts, counts)):
        lane_of[st * block_q:(st + ct) * block_q] = s
        row_of[st * block_q:(st + ct) * block_q] = np.arange(ct * block_q)
    real = torch.tensor((lane_of >= 0) & (row_of < np.array(q_lens)[lane_of]), device=out.device)
    pad = torch.tensor(lane_of >= 0, device=out.device) & ~real
    diff = (out.float() - ref.float()).abs()
    ratio = diff / (atol + rtol * ref.float().abs())
    parts = []
    for kind, rows in (("real rows", real), ("padding rows", pad)):
        if not bool(rows.any()):
            continue
        masked = torch.where(rows[None, :, None], diff, -1.0)
        h, tok, col = np.unravel_index(int(masked.argmax()), tuple(diff.shape))
        parts.append(f"{kind} {diff[h, tok, col].item():.3e} at head {h} lane {lane_of[tok]} row "
                     f"{row_of[tok]} column {col}, |ref| {ref[h, tok, col].float().abs().item():.4f}, "
                     f"largest error / allowance "
                     f"{torch.where(rows[None, :, None], ratio, 0.0).max().item():.3f}")
    return "; ".join(parts)


def _device_kernels(fn) -> list:
    """Names of the ragged device kernels that one call of `fn` runs, in
    order, from a profile of that call alone."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA and "ragged" in e.name]
    return [_ragged_name(e.name) for e in sorted(kernels, key=lambda e: e.time_range.start)]


def _ragged_name(name: str) -> str:
    """`ragged_wgmma<128,true>` from a profiler event's kernel name,
    demangled or mangled."""
    plain = re.search(r"ragged_[a-z_]+<[^>]*>", name)
    return plain.group(0).replace(" ", "") if plain else _kernel_name(name)


def _sdpa(q, k, v, causal):
    """One PyTorch call computing the flash function: the library yardstick,
    timed here and never called by the port."""
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    kx = torch.repeat_interleave(k, q.shape[1] // k.shape[1], dim=1)
    vx = torch.repeat_interleave(v, q.shape[1] // v.shape[1], dim=1)
    return F.scaled_dot_product_attention(q, kx, vx, is_causal=causal)


def _qkv(dtype, gen, shape):
    b, hq, hkv, s, d = shape
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    return q, k, v


def _qkv_do(dtype, gen, shape):
    q, k, v = _qkv(dtype, gen, shape)
    return q, k, v, torch.randn(q.shape, generator=gen, device="cuda", dtype=dtype)


def _fwd_launcher(q, k, v, causal, scale, launch=FLASH_FWD.launch):
    """The forward kernel alone on the wrapper's inputs (for its own time);
    `launch` takes the C launch function's arguments. The second item is
    (out, lse), which the launch fills."""
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s, 1), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], d, b, hq, k.shape[1], s, k.shape[2], int(causal),
            float(scale * _LOG2E), torch.cuda.current_stream().cuda_stream)
    return (lambda: launch(*args)), (out, lse)


def _fwd_checks(timer, dtype, gen, label, causal, atol, rtol) -> dict:
    """The flash forward kernel against _flash_fwd_plain (out and lse) and
    against its own second run (bitwise: one owner block per output row,
    one summing order); times of the bare launch, of the wrapper on
    contiguous tensors and on transposed views as the model's head split
    hands them (the wrapper copies those), of the plain version and of
    SDPA."""
    shape = FLASH_SHAPES[label]
    b, hq, hkv, s, d = shape
    q, k, v = _qkv(dtype, gen, shape)
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    ref, ref_lse = _flash_fwd_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = (torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
          and torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-4) and bool(torch.isfinite(out).all()))
    out2, lse2 = flash_attention_with_lse(q, k, v, causal=causal)
    deterministic = torch.equal(out, out2) and torch.equal(lse, lse2)
    del out2, lse2, ref, ref_lse
    launch, keep = _fwd_launcher(q, k, v, causal, scale)
    ms = timer.ms(launch, 20)
    del keep
    wrapper_ms = timer.ms(lambda: _flash_fwd_cuda(q, k, v, causal, scale), 10)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]  # (B, S, H, D) in memory
    views_ms = timer.ms(lambda: _flash_fwd_cuda(*views, causal, scale), 10)
    del views
    plain_ms = timer.ms(lambda: _flash_fwd_plain(q, k, v, causal, scale), 3)
    lib_ms = timer.ms(lambda: _sdpa(q, k, v, causal), 10)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + b * hq * s * 4
    pairs = s * (s + 1) / 2 if causal else s * s
    bound, bound_by = _bound_ms(nbytes, 4.0 * b * hq * d * pairs, dtype)
    name = str(dtype).replace("torch.", "")
    log("kernels", f"flash_attention_fwd {name} causal={causal} {label} B={b} GQA {hq}/{hkv} S={s} D={d}: "
        f"max_abs_err={err:.3e} lse_err={lse_err:.3e} atol={atol} rtol={rtol} "
        f"(lse 1e-4: f32 on both sides) kernel_ms={ms:.4f} wrapper_ms={wrapper_ms:.4f} "
        f"wrapper_on_views_ms={views_ms:.4f} (three copies) plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} ({bound_by}) library_ms={lib_ms:.4f} (SDPA) deterministic={deterministic}")
    if not ok:
        raise AssertionError(f"flash forward disagrees with its plain version ({name} {label} causal={causal})")
    if not deterministic:
        raise AssertionError(f"flash forward: two runs differ ({name} {label} causal={causal})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms, wrapper_ms=wrapper_ms, wrapper_on_views_ms=views_ms)


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


def _serve_run(engine, prompts):
    """Submit every greedy request at once and consume each stream on a
    thread of its own; returns (wall seconds, start time, [(time, token),
    ...] per request, the streams)."""
    stamps = [[] for _ in prompts]
    errors = [None] * len(prompts)
    t_start = time.perf_counter()
    streams = [engine.submit(p, max_tokens=MAX_TOKENS) for p in prompts]
    _join(_consume(streams, stamps, errors))
    if any(errors):
        raise AssertionError(f"a request failed: {errors}")
    return time.perf_counter() - t_start, t_start, stamps, streams


def _consume(streams, outs, errors, firsts=None):
    """One thread per stream: its tokens into outs[i] (time, token), a typed
    error into errors[i]; firsts[i] is set at its first token. Returns the
    threads, started."""
    def consume(i):
        try:
            for token in streams[i]:
                outs[i].append((time.perf_counter(), token))
                if firsts is not None:
                    firsts[i].set()
        except (BackPressureError, RequestTimeoutError) as exc:
            errors[i] = exc
        finally:
            if firsts is not None:
                firsts[i].set()

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(streams))]
    for th in threads:
        th.start()
    return threads


def _join(threads, timeout=600):
    for th in threads:
        th.join(timeout=timeout)
        if th.is_alive():
            raise RuntimeError(f"a request did not finish within {timeout} s")


def _add_launches(path: dict, stats: dict) -> None:
    """Add an engine's `launches.<kernel>` counts (replays x captured) of
    one run to the path's totals."""
    for key, n in stats.items():
        if key.startswith("launches."):
            path[key[len("launches."):]] = path.get(key[len("launches."):], 0) + int(n)


def _stats_delta(engine, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in engine.stats().items()}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profiled_ragged_kernels(engine, run) -> tuple:
    """The ragged device kernels of one more run of the same requests, by
    name, read from torch.profiler, the engine's own count for that run
    (replays x captured launches, from `engine.stats()`), and the run's
    wall, device busy time (kernels and copies on the card, as
    torch_serve_profile.py sums them) and sort kernels' time (in a greedy
    run only the accept step sorts)."""
    before = engine.stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = _stats_delta(engine, before)
    seen: dict = {}
    busy_us = sort_us = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        busy_us += _device_us(e)
        if "sort" in e.key.lower():
            sort_us += _device_us(e)
        if "ragged" in e.key:
            name = _ragged_name(e.key)
            seen[name] = seen.get(name, 0) + e.count
    return seen, counted, dict(wall_s=wall, busy_s=busy_us / 1e6, sort_s=sort_us / 1e6)


def _hold_ragged_against_profiler(phase, engine, prompts, run=None) -> dict:
    """Run the requests again under torch.profiler and hold its ragged
    device kernels against the engine's count for that run (replays x
    captured, by kind). The profiler can miss kernel records of a replayed
    graph (one repeat of the H100 runs saw 966 of 1024 decode walks and
    combines) but never sees more than ran: up to PROFILED_REPEATS repeats,
    each printed, and the first whose counts equal the engine's ends the
    check. `run` replaces the run of `prompts` on the engine. Returns the
    profiler's counts of that repeat."""
    run = run or (lambda: _serve_run(engine, prompts))
    for attempt in range(1, PROFILED_REPEATS + 1):
        seen, counted, times = _profiled_ragged_kernels(engine, run)
        want = {
            "ragged_wgmma<128,true>": int(counted.get("launches.ragged.decode", 0)),
            "ragged_combine<128>": int(counted.get("launches.ragged.decode", 0)),
            "ragged_wgmma<128,false>": int(counted.get("launches.ragged.mixed", 0)),
        }
        log(phase, f"profiled repeat {attempt}: ragged device kernels from torch.profiler "
            f"{seen}; the engine's count (replays x captured) {want}; wall "
            f"{times['wall_s']:.4f} s, device busy {times['busy_s']:.4f} s, idle share "
            f"{1 - times['busy_s'] / times['wall_s']:.4f}, sort kernels {times['sort_s']:.4f} s, "
            f"verify / decode passes {counted.get('decode_steps', 0):.0f}")
        if set(seen) - set(want) or any(seen.get(k, 0) > n for k, n in want.items()):
            raise AssertionError(f"the profiler saw ragged kernels the engine did not count: {seen}")
        if {k: seen.get(k, 0) for k in want} == want:
            return seen
    raise AssertionError(f"profiled ragged kernels {seen} differ from the engine's count {want} "
                         f"in {PROFILED_REPEATS} repeats")


def phase_serve():
    """Llama-3-8B served through the pipelined engine with every pass
    captured as a CUDA graph up front (precompile). The 8 greedy requests
    run unprofiled (wall, TTFT, decode rate; the main path's launches,
    counted by the engine as replays x the launches each capture
    recorded), then again under torch.profiler, whose ragged device
    kernels must equal the engine's count for that run; then one request
    at temperature 1 with top-k 50 (the filtered decode graph) must stay
    in the vocabulary and differ from its greedy twin."""
    t0 = time.perf_counter()
    config = get_config(MODEL).replace(param_dtype=torch.bfloat16)
    server = LLMServer(
        config, engine_config=PagedEngineConfig(max_slots=N_REQUESTS, precompile=True,
                                                paged=PagedConfig()),
        seed=SEED, device="cuda",
    )
    engine = server.engine
    torch.cuda.synchronize()
    log("serve", f"{MODEL}: {config.n_layers} layers d_model {config.d_model} "
        f"heads {config.n_heads}/{config.kv_heads} vocab {config.vocab_size}, bf16 "
        f"weights from seed {SEED} ({time.perf_counter() - t0:.2f} s)")
    passes = engine.passes()
    log("serve", f"precompile: {len(passes)} CUDA graphs captured in {engine.capture_s:.3f} s ("
        + ", ".join(f"{p.name} {p.capture_s:.3f} s" for p in passes)
        + f"); after capture {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    log("serve", "launches each capture recorded: "
        + "; ".join(f"{p.name} {p.captured}" for p in passes))
    if not all(p.is_captured for p in passes):
        raise AssertionError("precompile left a pass without its graph")
    rng = np.random.default_rng(SEED)
    # one short request first: the eager sampling and the pinned host allocator
    server.generate({"prompt_tokens": [1] * 64, "max_tokens": 2})
    lengths = np.linspace(64, 900, N_REQUESTS).astype(int)
    prompts = [rng.integers(0, config.vocab_size, n).tolist() for n in lengths]
    stats0, drains0 = engine.stats(), len(engine.drain_log)
    for kernel in KERNELS:
        kernel.launches = 0
    for kind in LAUNCHES_BY_KIND:
        LAUNCHES_BY_KIND[kind] = 0
    wall, t_start, stamps, _ = _serve_run(engine, prompts)
    stats = _stats_delta(engine, stats0)
    wrappers = {k.name: k.launches for k in KERNELS}
    outs = [[tok for _, tok in st] for st in stamps]
    for out in outs:
        if len(out) != MAX_TOKENS or not all(0 <= t < config.vocab_size for t in out):
            raise AssertionError(f"bad completion: {len(out)} tokens")
    # the main path's launches: through a wrapper (none: every pass replays
    # a graph) plus the graphs' replays x captured
    serve_counts = {name: n + int(stats.get(f"launches.{name}", 0)) for name, n in wrappers.items()}
    split = {kind: int(stats.get(f"launches.ragged.{kind}", 0)) for kind in LAUNCHES_BY_KIND}
    ttft = [st[0][0] - t_start for st in stamps]
    first_all = min(st[0][0] for st in stamps)
    last_all = max(st[-1][0] for st in stamps)
    decode_tokens = sum(len(st) - 1 for st in stamps)
    runs = {p.name: int(stats[f"passes.{p.name}"]) for p in passes}
    log("serve", f"{N_REQUESTS} requests, prompts {lengths.min()}-{lengths.max()} tokens, "
        f"{MAX_TOKENS} new each: wall {wall:.3f} s, TTFT p50 {statistics.median(ttft):.3f} s "
        f"max {max(ttft):.3f} s, decode {decode_tokens / (last_all - first_all):.1f} tok/s "
        f"(tokens after each request's first, over first-token-to-last-token), "
        f"output {N_REQUESTS * MAX_TOKENS / wall:.1f} tok/s over the wall, mixed ticks "
        f"{stats['mixed_ticks']:.0f}, decode blocks {stats['decode_blocks']:.0f}; graph replays "
        f"{runs}; ragged launches {serve_counts[RAGGED.name]} (mixed ticks {split['mixed']}, "
        f"decode steps {split['decode']}; through the wrapper {wrappers[RAGGED.name]})")
    drains = engine.drain_log[drains0:]
    log("serve", f"drain thread: {len(drains)} reads of {sum(n for n, _ in drains)} entries, "
        f"{sum(t for _, t in drains):.3f} s waiting on the card")
    if wrappers[RAGGED.name]:
        raise AssertionError("a serve pass launched the ragged kernels outside its graph")
    seen = _hold_ragged_against_profiler("serve", engine, prompts)
    filtered_before = engine.stats()["passes.decode.filtered"]
    hot = engine.generate(prompts[0], MAX_TOKENS, 1.0, top_k=50)
    differs = sum(a != b for a, b in zip(hot, outs[0]))
    log("serve", f"temperature 1, top-k 50: {len(hot)} tokens, {differs} differ from the greedy "
        f"twin's; filtered decode replays {engine.stats()['passes.decode.filtered'] - filtered_before:.0f}")
    if len(hot) != MAX_TOKENS or not all(0 <= t < config.vocab_size for t in hot) or not differs:
        raise AssertionError("temperature sampling left the vocabulary or repeated the greedy tokens")
    if engine.stats()["passes.decode.filtered"] == filtered_before:
        raise AssertionError("the top-k request never replayed the filtered decode graph")
    return server, config, prompts, outs, split, serve_counts, seen


def phase_check(server, config, prompts, outs) -> tuple:
    """Teacher-forced dense forward (flash kernel) over prompt + generated
    tokens: the engine's token at each generated position must score within
    CHECK_MARGIN of the dense argmax. Both paths compute in bf16 but round
    at different places (attention over pages, split at decode, against
    attention over the whole sequence; products of other shapes sum in
    other orders), so near-ties may flip; the margin is a few bf16 ulps of logits of this size (~0.03-0.06
    at |logit| 4-8), with room for that drift through 32 layers. Returns
    (exact, total, worst gap)."""
    log("check", f"margin {CHECK_MARGIN}: bf16 logits; paged (split at decode) and dense "
        f"attention and other product shapes round differently")
    return _dense_check("check", server.engine.params, config, prompts, outs)


def _dense_check(phase, params, config, prompts, outs, picks=None, labels=None,
                 margin=CHECK_MARGIN) -> tuple:
    """phase_check's test on the requests `picks` (default: the first and
    the last), every token within `margin` of the dense argmax; `labels`
    (one per request) groups the worst gaps in the log, each with the row's
    largest dense logit and the positions whose gap exceeds CHECK_MARGIN.
    Returns (exact, total, worst gap)."""
    t0 = time.perf_counter()
    before = FLASH_FWD.launches
    picks = picks or [0, len(prompts) - 1]
    worst, exact, total = 0.0, 0, 0
    # label -> [worst gap, (request, generated position), its row's max logit,
    #           positions over CHECK_MARGIN]
    groups: dict = {}
    with torch.no_grad():
        for i in picks:
            seq = prompts[i] + outs[i]
            tokens = torch.tensor([seq[:-1]], device="cuda")
            logits = forward(params, tokens, config)[0].float()
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite dense logits")
            rows = logits[len(prompts[i]) - 1:]
            chosen = torch.tensor(outs[i], device="cuda")
            top = rows.max(dim=-1).values
            gap = top - rows.gather(1, chosen[:, None])[:, 0]
            hit = rows.argmax(dim=-1) == chosen
            worst = max(worst, gap.max().item())
            exact += int(hit.sum())
            total += len(outs[i])
            if labels is not None:
                g = groups.setdefault(labels[i], [0.0, None, 0.0, 0])
                if gap.max().item() > g[0]:
                    at = int(gap.argmax())
                    g[0], g[1], g[2] = gap[at].item(), (i, at), top[at].item()
                g[3] += int((gap > CHECK_MARGIN).sum())
    launched = FLASH_FWD.launches - before
    log(phase, f"dense check (margin {margin}), {len(picks)} requests, {total} generated "
        f"positions: engine token == dense argmax at {exact}, worst gap {worst:.4f}, flash "
        f"launches {launched} ({time.perf_counter() - t0:.2f} s)")
    if groups:
        log(phase, "worst gap by group (gap, (request, generated position), the row's max dense "
            f"logit, positions over {CHECK_MARGIN}): "
            + "; ".join(f"{k} {v[0]:.4f} {v[1]} {v[2]:.3f} {v[3]}" for k, v in groups.items()))
    if launched == 0:
        raise AssertionError("the dense check never launched the flash kernel")
    if worst > margin:
        raise AssertionError(f"engine token scores {worst:.4f} below the dense argmax")
    return exact, total, worst


def _prefix_prompts(config) -> list:
    """N_REQUESTS prompts that share one PREFIX_TOKENS-token prefix (8
    pages of 64), each with a tail of its own of 64-448 tokens."""
    rng = np.random.default_rng(SEED + 2)
    prefix = rng.integers(0, config.vocab_size, PREFIX_TOKENS).tolist()
    tails = np.linspace(64, 448, N_REQUESTS).astype(int)
    return [prefix + rng.integers(0, config.vocab_size, n).tolist() for n in tails]


def _prefix_run(engine, prompts) -> dict:
    """The first request alone to completion (so that it registers the
    prefix where a cache is on), then the others at once; each request's
    tokens, TTFT and prompt tokens taken from the prefix cache."""
    first = engine.submit(prompts[0], max_tokens=MAX_TOKENS)
    out0 = first.result(timeout=600)
    wall, t_start, stamps, streams = _serve_run(engine, prompts[1:])
    return dict(outs=[out0] + [[tok for _, tok in st] for st in stamps],
                ttft=[first.ttft_s] + [st[0][0] - t_start for st in stamps],
                cached=[first.cached_tokens] + [st.cached_tokens for st in streams], wall=wall)


def _replay_ms(p, iters: int = 20) -> float:
    """Median device time of one replay of pass `p`'s graph over all-zero
    (inactive) inputs, whose writes land in the scratch page; CUDA events
    around each replay. The engine must be idle."""
    for t in p._static.values():
        t.zero_()
    p._graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        p._graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _accept_ms(config, iters: int = 20) -> float:
    """Median device time of the accept step alone on one verify round's
    logits (max_slots x (K+1) rows of the vocabulary, bf16), every lane
    active with K drafts, greedy; CUDA events."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    w = SPEC_TOKENS + 1
    logits = torch.randn((N_REQUESTS, w, config.vocab_size), generator=gen, device="cuda",
                         dtype=config.dtype)
    tokens = torch.randint(0, config.vocab_size, (N_REQUESTS, w), generator=gen, device="cuda")
    counts = torch.full((N_REQUESTS,), w, device="cuda")
    lane = [torch.zeros((N_REQUESTS,), device="cuda"), torch.zeros((N_REQUESTS,), dtype=torch.long,
                                                                  device="cuda"),
            torch.ones((N_REQUESTS,), device="cuda")]
    fn = lambda: accept_speculative(logits, tokens, counts, gen, *lane)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


class _Switch:
    """A proposer whose drafts come from `inner`, which the script switches
    between runs (an engine keeps the proposer it was built with)."""

    def __init__(self, inner):
        self.inner = inner

    def propose(self, context, k):
        return self.inner.propose(context, k)


def _spec_engine(label, config, params, proposer, prefix_cache: bool):
    t0 = time.perf_counter()
    engine = PagedLLMEngine(config, params, PagedEngineConfig(
        max_slots=N_REQUESTS, speculative_tokens=SPEC_TOKENS, speculative_proposer=proposer,
        precompile=True, paged=PagedConfig(prefix_cache=prefix_cache)), device="cuda")
    passes = engine.passes()
    log("spec", f"{label} engine: precompile: {len(passes)} CUDA graphs "
        f"captured in {engine.capture_s:.3f} s ("
        + ", ".join(f"{p.name} {p.capture_s:.3f} s" for p in passes)
        + f"); after capture {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; launches each capture "
        f"recorded: " + "; ".join(f"{p.name} {p.captured}" for p in passes)
        + f" ({time.perf_counter() - t0:.2f} s)")
    if not all(p.is_captured for p in passes) or engine._decode:
        raise AssertionError("the spec engine must capture its verify passes and no decode block")
    # the eager sampling of a first token and the pinned host allocator
    engine.generate([1, 2], max_tokens=2)
    return engine


def _spec_report(label, engine, before, wall, t_start, stamps) -> dict:
    """One spec run's numbers, printed: wall, TTFT, decode rate, the spec
    counters of the run and verify passes per generated token."""
    stats = _stats_delta(engine, before)
    ttft = [st[0][0] - t_start for st in stamps]
    first_all = min(st[0][0] for st in stamps)
    last_all = max(st[-1][0] for st in stamps)
    decode_tokens = sum(len(st) - 1 for st in stamps)
    proposed, accepted = stats["spec_proposed"], stats["spec_accepted"]
    rate = accepted / proposed if proposed else 0.0
    runs = {p.name: int(stats[f"passes.{p.name}"]) for p in engine.passes()}
    log("spec", f"{label}: {len(stamps)} requests, {MAX_TOKENS} new each: wall {wall:.3f} s, "
        f"TTFT p50 {statistics.median(ttft):.3f} s max {max(ttft):.3f} s, decode "
        f"{decode_tokens / (last_all - first_all):.1f} tok/s, output "
        f"{len(stamps) * MAX_TOKENS / wall:.1f} tok/s over the wall; spec_proposed "
        f"{proposed:.0f} spec_accepted {accepted:.0f} spec_acceptance_rate {rate:.4f} "
        f"spec_rollback_pages {stats['spec_rollback_pages']:.0f}; verify rounds "
        f"(decode_steps) {stats['decode_steps']:.0f} for {stats['decode_tokens']:.0f} decode "
        f"tokens: {stats['decode_steps'] / max(1.0, stats['decode_tokens']):.4f} verify passes "
        f"per generated token; mixed ticks {stats['mixed_ticks']:.0f}; graph replays {runs}; "
        f"ragged launches {int(stats.get('launches.ragged_paged_attention', 0))}")
    return dict(stats=stats, rate=rate)


def phase_spec(server, config, prompts, outs) -> dict:
    """Speculative decoding and the prefix cache on Llama-3-8B, sharing the
    serve phase's weight tensors: the replay drill (a ReplayProposer of the
    serve phase's greedy outputs), a run of 8 prompts sharing a 512-token
    prefix, a self-replay (a second engine, no prefix cache, replaying the
    drill's own tokens: the rate where drafts match), and a run drafted by
    a 2-layer cut of the model on that second engine. Returns each
    kernel's launches on this path (counted from zero just before it, the
    profiled repeat left out)."""
    t0 = time.perf_counter()
    params = server.engine.params
    pprompts = _prefix_prompts(config)
    base = _prefix_run(server.engine, pprompts)
    log("spec", f"prefix prompts ({PREFIX_TOKENS}-token shared prefix, tails "
        f"{len(pprompts[0]) - PREFIX_TOKENS}-{len(pprompts[-1]) - PREFIX_TOKENS}) on the serve "
        f"phase's engine (no cache, no speculation): TTFT first {base['ttft'][0]:.3f} s, the "
        f"other {N_REQUESTS - 1} p50 {statistics.median(base['ttft'][1:]):.3f} s max "
        f"{max(base['ttft'][1:]):.3f} s, wall of the {N_REQUESTS - 1} {base['wall']:.3f} s")
    replay = ReplayProposer({tuple(p): o for p, o in zip(prompts + pprompts, outs + base["outs"])})
    engine = _spec_engine("replay", config, params, replay, prefix_cache=True)
    draft_config = config.replace(n_layers=DRAFT_LAYERS)
    draft_params = {"wte": params["wte"], "lnf_scale": params["lnf_scale"],
                    "lm_head": params["lm_head"],
                    "blocks": {k: v[:DRAFT_LAYERS] for k, v in params["blocks"].items()}}
    draft = DraftModelProposer(draft_config, draft_params, window=DRAFT_WINDOW)
    switch = _Switch(draft)
    engine2 = _spec_engine("self-replay / draft-model", config, params, switch, prefix_cache=False)
    for kernel in KERNELS:
        kernel.launches = 0
    for kind in LAUNCHES_BY_KIND:
        LAUNCHES_BY_KIND[kind] = 0
    path = {}  # engine launches (replays x captured) on this path, summed

    # ---- replay drill
    before = engine.stats()
    wall, t_start, stamps, _ = _serve_run(engine, prompts)
    drill = _spec_report("replay drill", engine, before, wall, t_start, stamps)
    _add_launches(path, drill["stats"])
    spec_outs = [[tok for _, tok in st] for st in stamps]
    same = sum(a == b for a, b in zip(spec_outs, outs))
    log("spec", f"replay drill: {same} of {N_REQUESTS} token lists equal the serve phase's")
    if any(len(o) != MAX_TOKENS for o in spec_outs):
        raise AssertionError("a spec request returned the wrong number of tokens")
    if drill["stats"]["decode_steps"] == 0 or drill["rate"] == 0.0:
        raise AssertionError("the replay drill ran no verify round or accepted no draft")
    _dense_check("spec", params, config, prompts, spec_outs)
    profiled = _hold_ragged_against_profiler("spec", engine, prompts)
    # ---- prefix run
    before = engine.stats()
    run = _prefix_run(engine, pprompts)
    stats = _stats_delta(engine, before)
    _add_launches(path, stats)
    hit = sum(c > 0 for c in run["cached"])
    prompt_tokens = sum(len(p) for p in pprompts)
    log("spec", f"prefix run (prefix cache on, replay drafts of the serve engine's greedy "
        f"tokens): prefix_cache_hits {stats['prefix_cache_hits']:.0f} prefix_cache_misses "
        f"{stats['prefix_cache_misses']:.0f}, cached_tokens per request {run['cached']} "
        f"({hit} of {N_REQUESTS} hit), prefill tokens {stats['prefill_tokens']:.0f} of "
        f"{prompt_tokens} ({prompt_tokens - stats['prefill_tokens']:.0f} saved); TTFT first "
        f"{run['ttft'][0]:.3f} s (serve engine {base['ttft'][0]:.3f}), the other "
        f"{N_REQUESTS - 1} p50 {statistics.median(run['ttft'][1:]):.3f} s max "
        f"{max(run['ttft'][1:]):.3f} s (serve engine {statistics.median(base['ttft'][1:]):.3f} / "
        f"{max(base['ttft'][1:]):.3f}), wall of the {N_REQUESTS - 1} {run['wall']:.3f} s "
        f"(serve engine {base['wall']:.3f}); spec_proposed {stats['spec_proposed']:.0f} "
        f"spec_accepted {stats['spec_accepted']:.0f}; copy-on-write copies "
        f"{stats['prefix_cache_cow']:.0f}; {sum(a == b for a, b in zip(run['outs'], base['outs']))} "
        f"of {N_REQUESTS} token lists equal the serve engine's")
    if hit < N_REQUESTS - 1:
        raise AssertionError(f"only {hit} of {N_REQUESTS} prefix requests hit the cache")
    _dense_check("spec", params, config, pprompts, run["outs"], picks=[1, N_REQUESTS - 1])
    # ---- self-replay on the second engine
    switch.inner = ReplayProposer({tuple(p): o for p, o in zip(prompts, spec_outs)})
    before = engine2.stats()
    wall, t_start, stamps, _ = _serve_run(engine2, prompts)
    report = _spec_report("self-replay (drafts: the replay drill's own tokens; no prefix cache)",
                          engine2, before, wall, t_start, stamps)
    _add_launches(path, report["stats"])
    self_outs = [[tok for _, tok in st] for st in stamps]
    log("spec", f"self-replay: {sum(a == b for a, b in zip(self_outs, spec_outs))} of "
        f"{N_REQUESTS} token lists equal the replay drill's")
    _dense_check("spec", params, config, prompts, self_outs)
    _hold_ragged_against_profiler("spec self-replay", engine2, prompts)
    # ---- draft-model run
    switch.inner = draft
    flash0 = FLASH_FWD.launches
    before = engine2.stats()
    wall, t_start, stamps, _ = _serve_run(engine2, prompts[:2])
    flash_draft = FLASH_FWD.launches - flash0
    report = _spec_report(f"draft model ({DRAFT_LAYERS}-layer cut, window {DRAFT_WINDOW})",
                          engine2, before, wall, t_start, stamps)
    _add_launches(path, report["stats"])
    log("spec", f"draft model: flash forward launches on the draft path {flash_draft}")
    if report["stats"]["spec_proposed"] == 0 or flash_draft == 0:
        raise AssertionError("the draft model proposed nothing or never launched the flash kernel")
    _dense_check("spec", params, config, prompts[:2], [[t for _, t in st] for st in stamps])
    launches = {k.name: k.launches + path.get(k.name, 0) for k in KERNELS}
    if RAGGED.launches:
        raise AssertionError("a verify pass launched the ragged kernels outside its graph")
    # ---- pass and step times on idle engines (scratch-page writes only)
    times = {
        "serve decode.plain (16 steps)": _replay_ms(server.engine._decode["plain"]),
        "serve mixed.1": _replay_ms(server.engine._mixed[1]),
        "verify.1": _replay_ms(engine._mixed[1]),
        "verify.8": _replay_ms(engine._mixed[N_REQUESTS]),
        "accept step alone": _accept_ms(config),
    }
    log("spec", "device time of one replay over inactive inputs, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    for e in (engine, engine2):
        e.shutdown()
    log("spec", f"launches on the spec path {launches}, ragged by kind "
        f"{ {k: path.get(f'ragged.{k}', 0) for k in LAUNCHES_BY_KIND} } "
        f"({time.perf_counter() - t0:.2f} s)")
    return dict(launches=launches, profiled=profiled)


def phase_dense(server, config, prompts, serve_outs) -> dict:
    """LLMServer(engine_config=None) on the serve phase's weight tensors:
    the dense LLMEngine, its decode step one CUDA graph, its prefill eager
    (one flash launch per layer at B 1, S = the prompt's bucket). The serve
    phase's 8 greedy requests, unprofiled; the flash launches counted by
    the engine (prefills x layers), by the wrapper and by torch.profiler
    (a profiled repeat); the dense check on every request; one replay of
    the decode graph against eager decode_step, bitwise. Returns each
    kernel's launches on this path (the unprofiled run and the check)."""
    t0 = time.perf_counter()
    params = server.engine.params
    dense_server = LLMServer(config, params, EngineConfig(max_slots=N_REQUESTS,
                                                          max_seq=DENSE_MAX_SEQ), device="cuda")
    engine = dense_server.engine
    if type(engine) is not LLMEngine or not engine._decode.is_captured:
        raise AssertionError(f"engine_config=None built {type(engine).__name__}, or its decode "
                             "graph was not captured")
    torch.cuda.synchronize()
    log("dense", f"LLMServer(engine_config=EngineConfig(...)) built {type(engine).__name__}, "
        f"the engine engine_config=None builds: {N_REQUESTS} "
        f"slots, max_seq {engine.max_seq}, cache {engine.cache['k'].numel() * 2 * 2 / 2**30:.2f} "
        f"GiB; decode graph captured in {engine.capture_s:.3f} s (launches it recorded "
        f"{engine._decode.captured}); after capture {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    # one short request first: the eager prefill's cuBLAS handles and the pinned allocator
    dense_server.generate({"prompt_tokens": [1] * 64, "max_tokens": 2})
    for kernel in KERNELS:
        kernel.launches = 0
    stats0 = engine.stats()
    wall, t_start, stamps, _ = _serve_run(engine, prompts)
    stats = _stats_delta(engine, stats0)
    outs = [[tok for _, tok in st] for st in stamps]
    if any(len(o) != MAX_TOKENS for o in outs):
        raise AssertionError("a dense request returned the wrong number of tokens")
    launches = {k.name: k.launches for k in KERNELS}
    flash = FLASH_FWD.launches
    counted = int(stats["prefills"]) * config.n_layers
    ttft = [st[0][0] - t_start for st in stamps]
    first_all, last_all = min(st[0][0] for st in stamps), max(st[-1][0] for st in stamps)
    decode_tokens = sum(len(st) - 1 for st in stamps)
    # the 8 prefills run one after another before the first decode step:
    # the rate once every lane decodes, from the last first token on
    last_first = max(st[0][0] for st in stamps)
    steady = sum(1 for st in stamps for t, _ in st if t > last_first)
    log("dense", f"{N_REQUESTS} requests, {MAX_TOKENS} new each: wall {wall:.3f} s, TTFT p50 "
        f"{statistics.median(ttft):.3f} s max {max(ttft):.3f} s, decode "
        f"{decode_tokens / (last_all - first_all):.1f} tok/s ({steady / (last_all - last_first):.1f} "
        f"tok/s after the last first token), prefill span {last_first - first_all:.3f} s, output "
        f"{N_REQUESTS * MAX_TOKENS / wall:.1f} tok/s over the wall; decode graph replays "
        f"{stats['passes.decode']:.0f} (decode steps {stats['decode_steps']:.0f}); prefills "
        f"{stats['prefills']:.0f}; flash forward launches counted by the engine (prefills x "
        f"layers) {counted}, through the wrapper {flash}; {sum(a == b for a, b in zip(outs, serve_outs))} "
        f"of {N_REQUESTS} token lists equal the paged serve phase's")
    if flash != counted or flash == 0:
        raise AssertionError(f"flash launches {flash} differ from prefills x layers {counted}")
    # a profiled repeat: torch.profiler's flash kernels against the engine's count
    before = engine.stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        _serve_run(engine, prompts)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - tp
    prof_stats = _stats_delta(engine, before)
    seen = sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA and "flash_fwd" in e.key)
    busy = sum(_device_us(e) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e6
    want = int(prof_stats["prefills"]) * config.n_layers
    log("dense", f"profiled repeat: flash forward device kernels from torch.profiler {seen}, "
        f"the engine's count (prefills x layers) {want}; wall {pwall:.4f} s, device busy "
        f"{busy:.4f} s, idle share {1 - busy / pwall:.4f}")
    if seen != want:
        raise AssertionError(f"torch.profiler saw {seen} flash kernels, the engine counted {want}")
    before_flash = FLASH_FWD.launches
    _dense_check("dense", params, config, prompts, outs, picks=list(range(N_REQUESTS)))
    launches[FLASH_FWD.name] += FLASH_FWD.launches - before_flash
    # one replay of the decode graph against eager decode_step, on the idle
    # engine: the 8 lanes continue their streams at their own positions
    tokens = np.array([o[-1] for o in outs], np.int64)
    positions = np.array([len(p) + MAX_TOKENS - 1 for p in prompts], np.int64)
    saved = {k: v.clone() for k, v in engine.cache.items()}
    with torch.no_grad():
        graphed = engine._decode(tokens=tokens, positions=positions,
                                 temps=np.zeros(N_REQUESTS, np.float32)).clone()
        after = {k: v.clone() for k, v in engine.cache.items()}
        for k, v in saved.items():
            engine.cache[k].copy_(v)
        logits, _ = decode_step(params, engine.cache, torch.from_numpy(tokens).cuda(),
                                torch.from_numpy(positions).cuda(), config)
        eager = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    same = torch.equal(graphed, eager) and all(torch.equal(after[k], engine.cache[k]) for k in after)
    step_ms = _replay_ms(engine._decode)
    log("dense", f"decode graph replay vs eager decode_step: tokens and cache bitwise equal "
        f"{same}; one replay {step_ms:.4f} ms ({time.perf_counter() - t0:.2f} s)")
    del saved, after
    dense_server.shutdown()
    if not same:
        raise AssertionError("the dense decode graph differs from eager decode_step")
    return launches


def _overload_prompts(config, rng, n, lo, hi):
    return [rng.integers(0, config.vocab_size, int(k)).tolist()
            for k in np.linspace(lo, hi, n).astype(int)]


def _overload_run(engine, lows, highs) -> dict:
    """The 4 priority-0 lanes, then, once each has its first token, the 2
    priority-1 requests; every stream to its end. Returns the tokens, the
    priority-1 TTFTs (from their submit) and the engine counters of the
    run."""
    before = engine.stats()
    streams = [engine.submit(p, max_tokens=OVERLOAD_LOW_TOKENS, tenant="bulk", priority=0)
               for p in lows]
    outs = [[] for _ in range(len(lows) + len(highs))]
    errors = [None] * len(outs)
    firsts = [threading.Event() for _ in lows]
    threads = _consume(streams, outs, errors, firsts)
    for ev in firsts:
        ev.wait(timeout=600)
    t_high = time.perf_counter()
    hstreams = [engine.submit(p, max_tokens=OVERLOAD_HIGH_TOKENS, tenant="paid", priority=1)
                for p in highs]
    threads += _consume(hstreams, outs[len(lows):], errors[len(lows):])
    _join(threads)
    if any(errors):
        raise AssertionError(f"an overload stream failed: {errors}")
    stats = _stats_delta(engine, before)
    # a resumed lane was charged its parked wait at re-admission
    victims = [i for i, st in enumerate(streams) if st._request.preempt_wait_s > 0]
    return dict(outs=[[t for _, t in o] for o in outs], stats=stats, victims=victims,
                high_ttft=[o[0][0] - t_high for o in outs[len(lows):]])


def _overload_pair(engine, lows, highs, label, finished, path) -> dict:
    """The overload run with preemption on, then off, on one engine; each
    run's numbers printed, its streams added to `finished` (prompt, tokens,
    group) and its launches to `path`. Returns both runs."""
    runs = {}
    for preempt in (True, False):
        cfg.set(serve_lane_preemption=preempt)
        try:
            run = _overload_run(engine, lows, highs)
        finally:
            cfg.reset()
        _add_launches(path, run["stats"])
        st = run["stats"]
        runs[preempt] = run
        group = f"{label}, preemption {'on' if preempt else 'off'}"
        finished += [(p, o, f"{group}, " + ("priority 1" if i >= len(lows) else
                                             "resumed" if i in run["victims"] else "priority 0"))
                     for i, (p, o) in enumerate(zip(lows + highs, run["outs"]))]
        log("overload", f"{group}: 4 x priority 0 ({len(lows[0])} tokens, "
            f"{OVERLOAD_LOW_TOKENS} new) then 2 x priority 1 ({len(highs[0])} tokens, "
            f"{OVERLOAD_HIGH_TOKENS} new): priority-1 TTFT "
            + ", ".join(f"{t:.3f}" for t in run["high_ttft"]) + " s; lane_preemptions "
            f"{st['lane_preemptions']:.0f} preempted_pages {st['preempted_pages']:.0f} "
            f"lane_resumes {st['lane_resumes']:.0f} page_stalls {st['page_stalls']:.0f}; "
            f"resumed lanes {run['victims']}; ragged launches "
            f"{int(st.get('launches.ragged_paged_attention', 0))}")
        if any(len(o) != n for o, n in zip(run["outs"], [OVERLOAD_LOW_TOKENS] * len(lows)
                                           + [OVERLOAD_HIGH_TOKENS] * len(highs))):
            raise AssertionError(f"{group}: a stream ended short")
    on, off = runs[True], runs[False]
    same = [next((j for j, (a, b) in enumerate(zip(on["outs"][i], off["outs"][i])) if a != b),
                 OVERLOAD_LOW_TOKENS) for i in on["victims"]]
    log("overload", f"{label}: each resumed lane's tokens equal the same prompt's unpreempted "
        f"tokens (preemption off) for the first {same} of {OVERLOAD_LOW_TOKENS}")
    if off["stats"]["lane_preemptions"] != 0:
        raise AssertionError("a lane was preempted with serve_lane_preemption=False")
    if on["stats"]["lane_resumes"] != on["stats"]["lane_preemptions"]:
        raise AssertionError("fewer lanes resumed than were parked")
    return runs


def phase_overload(server, config) -> dict:
    """Overload handling of the paged engine on the serve phase's weights:
    lane preemption (against the same run with preemption off), then the
    queue-bound burst, a tenant over its quota and 0.2 s deadlines behind
    long lanes, then the preemption pair on a second engine with 1 block
    in flight (a marked victim parks once its in-flight blocks drain).
    Returns each kernel's launches on this path (the unprofiled runs,
    drills and dense checks)."""
    t0 = time.perf_counter()
    params = server.engine.params
    engine = PagedLLMEngine(config, params, PagedEngineConfig(
        max_slots=OVERLOAD_SLOTS, precompile=True,
        paged=PagedConfig(num_pages=OVERLOAD_PAGES)), device="cuda")
    pc = engine.paged
    passes = engine.passes()
    log("overload", f"engine: {OVERLOAD_SLOTS} slots, {pc.num_pages - 1} allocatable pages of "
        f"{pc.page_size}, queue bound {engine.config.max_queued_requests or 8 * OVERLOAD_SLOTS}; "
        f"{len(passes)} CUDA graphs captured in {engine.capture_s:.3f} s; after capture "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engine.generate([1, 2], max_tokens=2)
    # the same pair on a shallow pipeline: a marked victim drains 1 block
    # (built here: a capture's warm-up runs through the kernel wrappers)
    shallow = PagedLLMEngine(config, params, PagedEngineConfig(
        max_slots=OVERLOAD_SLOTS, max_inflight_blocks=1, precompile=True,
        paged=PagedConfig(num_pages=OVERLOAD_PAGES)), device="cuda")
    shallow.generate([1, 2], max_tokens=2)
    rng = np.random.default_rng(SEED + 3)
    lows = _overload_prompts(config, rng, OVERLOAD_SLOTS, 512, 512)
    highs = _overload_prompts(config, rng, 2, 128, 128)
    for kernel in KERNELS:
        kernel.launches = 0
    path: dict = {}  # engine launches (replays x captured) on this path, summed

    finished = []  # (prompt, tokens, group) of every stream that ended with tokens
    runs = _overload_pair(engine, lows, highs, f"{engine.config.max_inflight_blocks} blocks in "
                          "flight", finished, path)
    if runs[True]["stats"]["lane_preemptions"] < 1:
        raise AssertionError("the overload run preempted no lane")
    # ---- burst past the queue bound
    before = engine.stats()
    burst_prompts = _overload_prompts(config, rng, 3 * 8 * OVERLOAD_SLOTS, 16, 48)
    accepted, shed = [], 0
    for p in burst_prompts:
        try:
            accepted.append((p, engine.submit(p, max_tokens=4, tenant="burst")))
        except BackPressureError as exc:
            shed += 1
            if exc.retry_after_s is not None:
                raise AssertionError("a queue-bound shed carried a retry estimate")
    outs = [[] for _ in accepted]
    errors = [None] * len(accepted)
    _join(_consume([s for _, s in accepted], outs, errors))
    ok = sum(len(o) == 4 for o in outs)
    finished += [(p, [t for _, t in o], "burst") for (p, _), o in zip(accepted, outs)]
    st = _stats_delta(engine, before)
    _add_launches(path, st)
    log("overload", f"burst of {len(burst_prompts)} submits (queue bound "
        f"{8 * OVERLOAD_SLOTS}): {len(accepted)} accepted, all ended with 4 tokens: "
        f"{ok == len(accepted)}; {shed} BackPressureError (shed counter {st['shed']:.0f})")
    if shed == 0 or ok != len(accepted) or st["shed"] != shed:
        raise AssertionError("the burst shed nothing, or an accepted request did not end")
    # ---- a tenant over its quota
    tenancy.set_tenant("metered", quota_rps=1.0)
    before = engine.stats()
    q_ok, retry = [], []
    for p in burst_prompts[:5]:
        try:
            q_ok.append((p, engine.submit(p, max_tokens=4, tenant="metered")))
        except BackPressureError as exc:
            retry.append(exc.retry_after_s)
    outs = [[] for _ in q_ok]
    errors = [None] * len(q_ok)
    _join(_consume([s for _, s in q_ok], outs, errors))
    finished += [(p, [t for _, t in o], "quota") for (p, _), o in zip(q_ok, outs)]
    _add_launches(path, _stats_delta(engine, before))
    tenancy.reset()
    log("overload", f"tenant at quota_rps 1 (burst 2), 5 submits: {len(q_ok)} accepted, "
        f"{len(retry)} BackPressureError with retry_after_s "
        + ", ".join(f"{r:.3f}" for r in retry))
    if not retry or not all(r is not None and 0 < r < 10 for r in retry) or any(errors):
        raise AssertionError("the quota shed nothing or gave no finite retry_after_s")
    # ---- deadlines behind long lanes
    before = engine.stats()
    longs = [engine.submit(p, max_tokens=OVERLOAD_LOW_TOKENS, tenant="bulk")
             for p in lows[:OVERLOAD_SLOTS - 1]]
    deadline = time.time() + DEADLINE_S
    doomed = [engine.submit(p, max_tokens=OVERLOAD_LOW_TOKENS, tenant="late",
                            deadline_ts=deadline) for p in [lows[-1]] + highs]
    streams = longs + doomed
    outs = [[] for _ in streams]
    errors = [None] * len(streams)
    _join(_consume(streams, outs, errors))
    st = _stats_delta(engine, before)
    _add_launches(path, st)
    finished += [(p, [t for _, t in o], "deadline drill, long lane")
                 for p, o in zip(lows, outs[:len(longs)])]
    timed = [(len(o), type(e).__name__) for o, e in zip(outs[len(longs):], errors[len(longs):])]
    log("overload", f"{len(doomed)} requests with {DEADLINE_S} s deadlines behind "
        f"{len(longs)} long lanes: (tokens before the error, error) {timed}; timeouts counter "
        f"{st['timeouts']:.0f}; the long lanes ended with "
        f"{[len(o) for o in outs[:len(longs)]]} tokens")
    if any(not isinstance(e, RequestTimeoutError) for e in errors[len(longs):]) or any(
            errors[:len(longs)]) or st["timeouts"] != len(doomed):
        raise AssertionError("a deadline request did not end with RequestTimeoutError")
    deadline_wait = time.time() + 30
    while time.time() < deadline_wait:
        free = engine.stats()["pages_free"]
        if free == pc.num_pages - 1:
            break
        time.sleep(0.01)
    log("overload", f"after the drills: pages_free {free:.0f} of {pc.num_pages - 1}")
    if free != pc.num_pages - 1:
        raise AssertionError("the page pool did not return to full")
    # ---- the preemption pair on the shallow pipeline
    _overload_pair(shallow, lows, highs, "1 block in flight", finished, path)
    if shallow.stats()["pages_free"] != pc.num_pages - 1:
        raise AssertionError("the shallow engine's page pool did not return to full")
    shallow.shutdown()
    launches = {k.name: k.launches + path.get(k.name, 0) for k in KERNELS}
    if RAGGED.launches:
        raise AssertionError("an overload pass launched the ragged kernels outside its graph")
    # ---- the teacher-forced check on every finished stream (resumed victims included)
    prompts_f, outs_f = [p for p, _, _ in finished], [o for _, o, _ in finished]
    before_flash = FLASH_FWD.launches
    _dense_check("overload", params, config, prompts_f, outs_f, picks=list(range(len(finished))),
                 labels=[g for _, _, g in finished], margin=OVERLOAD_CHECK_MARGIN)
    launches[FLASH_FWD.name] += FLASH_FWD.launches - before_flash
    # ---- ragged launches of a preempting run, held against torch.profiler
    cfg.set(serve_lane_preemption=True)
    try:
        counts = {}

        def profiled():
            counts.update(_overload_run(engine, lows, highs)["stats"])

        profiled_seen = _hold_ragged_against_profiler("overload", engine, lows, run=profiled)
    finally:
        cfg.reset()
    log("overload", f"profiled preempting run: lane_preemptions {counts['lane_preemptions']:.0f}, "
        f"lane_resumes {counts['lane_resumes']:.0f}; launches on the overload path "
        f"{launches}, ragged by kind { {k: path.get(f'ragged.{k}', 0) for k in LAUNCHES_BY_KIND} } "
        f"({time.perf_counter() - t0:.2f} s)")
    engine.shutdown()
    return dict(launches=launches, profiled=profiled_seen)


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
    log("train", f"launches per step {per_step} (each flash kernel must show "
        f"{config.n_layers}: one per layer) ({time.perf_counter() - t0:.2f} s)")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    if not losses[-1] < LOSS_MARGIN * losses[0]:
        raise AssertionError(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}: not below "
                             f"{LOSS_MARGIN} x the first")
    for kernel in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
        if launches[kernel.name] != config.n_layers * TRAIN_STEPS:
            raise AssertionError(f"{kernel.name}: {launches[kernel.name]} launches in "
                                 f"{TRAIN_STEPS} steps, want {config.n_layers} per step")
    return launches


class _TokenStream:
    """A token stream made with numpy from a seed, as blocks for
    lm_batch_iterator: the same TRAIN_BATCH x (TRAIN_SEQ + 1) window of
    uniform draws, flattened, once per step (the train phase's regime of
    one fixed batch, which LOSS_MARGIN is set for)."""

    def __init__(self, vocab: int, seed: int, steps: int):
        rng = np.random.default_rng(seed)
        self.window = rng.integers(0, vocab, TRAIN_BATCH * (TRAIN_SEQ + 1), dtype=np.int32)
        self.steps = steps

    def iter_blocks(self):
        for _ in range(self.steps):
            yield {"tokens": self.window}


def _lm_trainer(config, ckpt_dir: str, ckpt_every: int) -> LMTrainer:
    """LMTrainer on the card with the train phase's optimizer (lr 1e-3,
    warmup 2, cosine over TRAIN_STEPS) and asynchronous checkpoints."""
    return LMTrainer(
        config, optimizer=default_optimizer(TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS),
        learning_rate=TRAIN_LR, total_steps=TRAIN_STEPS, seed=SEED, device="cuda",
        checkpoint_config=CheckpointConfig(checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                                           async_save=True))


def _record_steps(trainer: LMTrainer):
    """Keep each step's loss tensor and a CUDA event recorded after the
    step, through the trainer's step_fn: nothing is read back, so the
    queue keeps running ahead. Returns (losses, ends)."""
    losses, ends = [], []
    step = trainer.step_fn

    def recording(state, batch):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        ends.append(end)
        return state, metrics

    trainer.step_fn = recording
    return losses, ends


def _step_flops_closed_form(config) -> float:
    """FLOPs of the step's products: each matrix product three times (the
    forward, dX and dW), and attention's 2 + 5 products of 2 * D per causal
    pair (the flash kernels' function)."""
    b, s, e, f, v, h, d, n = (TRAIN_BATCH, TRAIN_SEQ, config.d_model, config.d_ff, config.vocab_size,
                              config.n_heads, config.head_dim, config.n_layers)
    products = 2.0 * b * s * (4 * e * e + 2 * e * f) * n + 2.0 * b * s * e * v
    return 3 * products + 14.0 * b * h * d * s * (s + 1) / 2 * n


def _checkpoint_drill(state, directory: str) -> dict:
    """Seconds and bytes of two saves of the trained state (the first one
    allocates the pinned buffer, the second reuses it): the snapshot the
    caller waits for, then the write on the thread (file, sha256 manifest,
    COMMIT); then a verified restore onto the card."""
    mgr = CheckpointManager(directory, async_save=True)
    out = {}
    for label, step in (("first", state.step), ("second", state.step + 1)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mgr.save(step, state)
        out[f"{label}_snapshot_s"] = time.perf_counter() - t
        mgr.wait_until_finished()
        out[f"{label}_write_s"] = time.perf_counter() - t - out[f"{label}_snapshot_s"]
    out["bytes"] = os.path.getsize(os.path.join(directory, str(state.step), "state.bin"))
    t = time.perf_counter()
    back = mgr.restore(state, device=state.params["wte"].device)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(back.params), tree_leaves(state.params)))
    mgr.close()
    if not same:
        raise AssertionError("checkpoint drill: restored params differ from the saved ones")
    return out


def phase_trainer() -> dict:
    """LMTrainer on GPT-2 124M through lm_batch_iterator, with checkpoints,
    the step log and step MFU; returns each kernel's launches over the
    20-step run (counted from zero just before it)."""
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    cfg.set(step_log_sample_every=TRAINER_SAMPLE_EVERY)
    try:
        return _trainer_run(get_config(TRAIN_MODEL), ckpt_dir)
    finally:
        cfg.reset("step_log_sample_every")
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _trainer_run(config, ckpt_dir: str) -> dict:
    t0 = time.perf_counter()
    run = "chip_smoke"
    trainer = _lm_trainer(config, ckpt_dir, TRAINER_CKPT_EVERY)
    # the cost count, ahead of the run so that no report window carries it
    probe = {"tokens": torch.zeros((TRAIN_BATCH, TRAIN_SEQ + 1), dtype=torch.int32,
                                   device=trainer.device)}
    t = time.perf_counter()
    cost = trainer.step_cost(probe)
    cost_s = time.perf_counter() - t
    closed = _step_flops_closed_form(config)
    log("trainer", f"{TRAIN_MODEL}: {trainer.num_params} params, device {trainer.device}; step cost "
        f"counted on meta tensors in {cost_s:.3f} s: {cost.flops:.6e} FLOPs ({cost.flops / closed:.6f} "
        f"of the products' closed form {closed:.6e}), {cost.bytes_accessed:.6e} bytes, peaks "
        f"{cost.peak_flops:.3e} FLOP/s {cost.peak_hbm_bps:.3e} B/s ({cost.device_kind}: "
        f"{'nominal fallback' if cost.estimated_peaks else 'published'} peaks); largest: "
        + ", ".join(f"{k} {v:.3e}" for k, v in cost.top_buckets(8)))
    losses, ends = _record_steps(trainer)
    reports = []
    stream = _TokenStream(config.vocab_size, SEED + 2, TRAIN_STEPS)
    torch.cuda.synchronize()
    for kernel in KERNELS:
        kernel.launches = 0
    t = time.perf_counter()
    trainer.train(lm_batch_iterator(stream, TRAIN_SEQ, TRAIN_BATCH, device="cuda"),
                  num_steps=TRAIN_STEPS, report_every=TRAINER_REPORT_EVERY,
                  report_fn=reports.append, run_name=run)
    run_s = time.perf_counter() - t
    launches = {k.name: k.launches for k in KERNELS}
    loss = [x.item() for x in losses]
    # device time between consecutive steps' ends (step n = ends[n-1] - ends[n-2]);
    # a step right after a host synchronisation (a sampled step, a report's
    # read-back, a checkpoint's snapshot) starts on an empty queue
    gaps = {n: ends[n - 2].elapsed_time(ends[n - 1]) for n in range(2, TRAIN_STEPS + 1)}
    synced = set()
    for r in reports:
        synced.add(r["step"])
        synced.update(rec["step"] for rec in r.get("_steplog", []))
    synced.update(range(TRAINER_CKPT_EVERY, TRAIN_STEPS + 1, TRAINER_CKPT_EVERY))
    queued = [gaps[n] for n in gaps if n - 1 not in synced]
    step_ms = statistics.median(queued)
    ntok = TRAIN_BATCH * TRAIN_SEQ
    log("trainer", f"{TRAIN_STEPS} steps in {run_s:.3f} s (first step's set-up included), "
        f"{ntok * TRAIN_STEPS / run_s:.1f} tokens/s over the run; device time a step, steps whose "
        f"predecessor ended on a queue (no sync): median {step_ms:.3f} ms (min {min(queued):.3f}, "
        f"max {max(queued):.3f}, {len(queued)} steps) = {ntok / step_ms * 1e3:.1f} tokens/s; every "
        f"step: " + " ".join(f"{n}:{gaps[n]:.2f}" for n in sorted(gaps)))
    log("trainer", "loss " + " ".join(f"{x:.4f}" for x in loss))
    sampled = []
    for r in reports:
        log("trainer", f"report at step {r['step']}: tokens_per_sec {r['tokens_per_sec']:.1f} "
            f"step_time_s {r.get('step_time_s', float('nan')):.6f} mfu {r.get('mfu', float('nan')):.6f} "
            f"step_flops {r.get('step_flops', float('nan')):.6e} step_bytes "
            f"{r.get('step_bytes', float('nan')):.6e} roofline_hbm {r.get('roofline_hbm', float('nan')):.6f} "
            f"({r.get('roofline_bound')}) input_wait_s {r['input_wait_s']} ckpt_save_s {r['ckpt_save_s']} "
            f"dp_sync_s {r['dp_sync_s']} ({r.get('dp_sync_mode')}, {r.get('dp_sync_bytes')} bytes) "
            f"loss {r['loss']:.4f}")
        for rec in r.get("_steplog", []):
            sampled.append(rec)
            log("trainer", f"  sampled step {rec['step']}: wall_s {rec['wall_s']:.6f} = "
                + " + ".join(f"{k} {v:.6f}" for k, v in rec["buckets"].items())
                + f" (sum {sum(rec['buckets'].values()):.6f})")
    log("trainer", "\n" + steplog.render_waterfall(steplog.log().steps(run=run)))
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    log("trainer", f"launches per step {per_step} (each flash kernel must show {config.n_layers})")
    drill = _checkpoint_drill(trainer.state, os.path.join(ckpt_dir, "drill"))
    log("trainer", f"checkpoint drill: {drill['bytes']} bytes of state.bin; first save: snapshot "
        f"{drill['first_snapshot_s']:.3f} s (pinned buffer allocated) + write "
        f"{drill['first_write_s']:.3f} s; second save: snapshot {drill['second_snapshot_s']:.3f} s "
        f"+ write {drill['second_write_s']:.3f} s; verified restore {drill['restore_s']:.3f} s")
    # checks
    if not all(np.isfinite(loss)):
        raise AssertionError("trainer: non-finite training loss")
    if not loss[-1] < LOSS_MARGIN * loss[0]:
        raise AssertionError(f"trainer: loss {loss[0]:.4f} -> {loss[-1]:.4f}: not below "
                             f"{LOSS_MARGIN} x the first")
    for kernel in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
        if launches[kernel.name] != config.n_layers * TRAIN_STEPS:
            raise AssertionError(f"trainer: {kernel.name}: {launches[kernel.name]} launches in "
                                 f"{TRAIN_STEPS} steps, want {config.n_layers} per step")
    want_sampled = len(range(0, TRAIN_STEPS, TRAINER_SAMPLE_EVERY))
    if len(sampled) != want_sampled:
        raise AssertionError(f"trainer: {len(sampled)} sampled steps reported, want {want_sampled}")
    for rec in sampled:
        total = sum(rec["buckets"].values())
        if abs(total - rec["wall_s"]) > 1e-9 * rec["wall_s"]:
            raise AssertionError(f"trainer: sampled step {rec['step']}: buckets sum to {total!r}, "
                                 f"wall_s {rec['wall_s']!r}")
    for r in reports:
        if not 0.0 < r.get("mfu", float("nan")) < 1.0:
            raise AssertionError(f"trainer: report at step {r['step']}: mfu {r.get('mfu')} not in (0, 1)")
    second = _lm_trainer(config, ckpt_dir, TRAINER_CKPT_EVERY)
    t = time.perf_counter()
    restored = second.maybe_restore()
    restore_s = time.perf_counter() - t
    trees = [(second.state.params, trainer.state.params),
             (second.state.opt_state.mu, trainer.state.opt_state.mu),
             (second.state.opt_state.nu, trainer.state.opt_state.nu)]
    bitwise = all(torch.equal(a, b) for x, y in trees for a, b in zip(tree_leaves(x), tree_leaves(y)))
    count_ok = second.state.opt_state.count == trainer.state.opt_state.count == TRAIN_STEPS
    log("trainer", f"second trainer: maybe_restore() = {restored} in {restore_s:.3f} s; params and "
        f"moments bitwise equal: {bitwise}; count {second.state.opt_state.count}")
    del second
    if restored != TRAIN_STEPS or not bitwise or not count_ok:
        raise AssertionError("trainer: the second trainer did not restore step 20 bitwise")
    resumed = _lm_trainer(config, ckpt_dir, 0)
    if resumed.restore(TRAINER_RESUME_FROM) != TRAINER_RESUME_FROM:
        raise AssertionError(f"trainer: restore({TRAINER_RESUME_FROM}) returned another step")
    again, _ = _record_steps(resumed)
    resumed.train(lm_batch_iterator(_TokenStream(config.vocab_size, SEED + 2, TRAINER_RESUME_STEPS),
                                    TRAIN_SEQ, TRAIN_BATCH, device="cuda"),
                  num_steps=TRAINER_RESUME_STEPS, report_every=TRAINER_REPORT_EVERY,
                  run_name=run + "-resume")
    redo = [x.item() for x in again]
    first = loss[TRAINER_RESUME_FROM:TRAINER_RESUME_FROM + TRAINER_RESUME_STEPS]
    gap = max(abs(a - b) for a, b in zip(redo, first))
    log("trainer", f"restored at step {TRAINER_RESUME_FROM}, steps {TRAINER_RESUME_FROM + 1}-"
        f"{TRAINER_RESUME_FROM + TRAINER_RESUME_STEPS}: loss " + " ".join(f"{x!r}" for x in redo)
        + f"; first run " + " ".join(f"{x!r}" for x in first) + f"; bitwise {redo == first}, "
        f"largest gap {gap!r} ({time.perf_counter() - t0:.2f} s)")
    del resumed
    if redo != first:
        raise AssertionError("trainer: the resumed run's losses differ from the first run's "
                             "(no kernel of the port uses atomics: the steps should repeat bitwise)")
    return dict(launches=launches, step_ms=step_ms)


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
    server, config, prompts, outs, ragged_split, serve_launches, profiled = phase_serve()
    if min(ragged_split.values()) == 0:
        raise AssertionError(f"the serving path never launched the ragged kernels of one kind: "
                             f"{ragged_split}")
    before = {k.name: k.launches for k in KERNELS}
    try:
        phase_check(server, config, prompts, outs)
        for k in KERNELS:
            serve_launches[k.name] += k.launches - before[k.name]
        spec = phase_spec(server, config, prompts, outs)
        dense_launches = phase_dense(server, config, prompts, outs)
        overload = phase_overload(server, config)
    finally:
        server.shutdown()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    trainer = phase_trainer()
    kernels = []
    for k in KERNELS:
        by_path = {"serve": serve_launches[k.name], "spec": spec["launches"][k.name],
                   "dense": dense_launches[k.name], "overload": overload["launches"][k.name],
                   "train": train_launches[k.name], "trainer": trainer["launches"][k.name]}
        kernels.append(dict(
            name=k.name, route="cuda", source=SOURCES[k.name], replaces=REPLACES[k.name],
            launches=sum(by_path.values()), launches_by_path=by_path, **results[k.name]))
        if k is RAGGED:
            kernels[-1]["serve_launches_by_kind"] = ragged_split
            kernels[-1]["serve_device_kernels_profiled_repeat"] = profiled
            kernels[-1]["spec_device_kernels_profiled_repeat"] = spec["profiled"]
            kernels[-1]["overload_device_kernels_profiled_repeat"] = overload["profiled"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
