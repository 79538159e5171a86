#!/usr/bin/env python3
"""Compare versions of an attention kernel source on one GPU.

    python3 torch_flash_ab.py fwd|bwd|ragged [--waves W,...] [OTHER.cu ...]
    python3 torch_flash_ab.py ragged-check

Builds ray_tpu_torch/ops/csrc/flash_attention_fwd.cu (fwd),
flash_attention_bwd.cu (bwd) or ragged_paged_attention.cu (ragged) as
"repo" and each OTHER.cu (a variant of it, e.g. `git show REV:path >
old.cu`; it finds the headers of csrc/) with the port's nvcc flags, one
process per source started together, prints each build's registers and
spills for the bf16 instances and any ptxas note about wgmma (C75xx),
holds each version's outputs against the plain version
(`_flash_fwd_plain`: out and lse; `_flash_bwd_plain`: dq, dk, dv;
`ragged_reference_attention`) and times each version's launches on the
same inputs in the order A B ... B A, so that drift of the card shows as
a difference between a version's two readings. The flash sides run at
chip_smoke.py's flash shapes (GPT-2 124M train shape, Llama GQA shape;
bf16, causal), the ragged side at chip_smoke.py's two ragged cases (a
mixed tick's batch and a decode step's; Llama-3-8B, bf16); a ragged
version must take the tree's launch arguments. `--waves W,...` (ragged)
adds the tree's source once more for each W, its decode calls split for
W blocks per SM instead of _SPLIT_TARGET_WAVES (`_split_plan`). Times
are medians of per-launch CUDA events with the L2 flushed (chip_smoke's
`_Timer`).

`ragged-check` runs chip_smoke.py's serve and check phases twice: on the
ragged kernels, then with the plain version in their place (it keeps p in
f32 before P.V, where the bf16 kernels round it to bf16), and prints each
run's check (engine tokens equal to the dense argmax, worst gap). Needs
one CUDA device.
"""

from __future__ import annotations

import ctypes
import gc
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from chip_smoke import (
    FLASH_SHAPES,
    _bwd_launchers,
    _fwd_launcher,
    _kernel_name,
    _qkv_do,
    _ragged_case,
    _ragged_decode_case,
    _run,
    _Timer,
)
from ray_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from ray_tpu_torch.ops.attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    _flash_bwd_plain,
    _flash_fwd_plain,
    flash_attention_with_lse,
)
from ray_tpu_torch.ops.ragged_paged_attention import (
    _DTYPE_CODES,
    RAGGED,
    _decode_workspace,
    ragged_reference_attention,
)
from ray_tpu_torch.serve.llm import paged

# the module itself (`ray_tpu_torch.ops.ragged_paged_attention` names the function)
ragged_mod = sys.modules["ray_tpu_torch.ops.ragged_paged_attention"]

ITERS = 20
# which -> (source, the kernels bound to it, the names of their outputs' times)
SIDES = {
    "fwd": ("flash_attention_fwd.cu", (FLASH_FWD,), ("fwd",)),
    "bwd": ("flash_attention_bwd.cu", (FLASH_BWD_DKV, FLASH_BWD_DQ), ("dkv", "dq")),
    "ragged": ("ragged_paged_attention.cu", (RAGGED,), ("ragged",)),
}


def _raising(name: str, fn):
    def call(*args):
        if fn(*args):
            raise RuntimeError(f"{name}: launch failed")
    return call


def _build(sources: dict, kernels) -> dict:
    """{name: (library, launch function per kernel)} of every source that
    built; a launch raises when the C function returns an error."""
    out_dir = BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in sources.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-4000:]}", flush=True)
            continue
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "bfloat16" in entry and ("Used" in line or "spill stores" in line):
                kind = _kernel_name(entry)
                print(f"{name}: {kind}: {line.split('info    :', 1)[-1].strip()}", flush=True)
            if "C75" in line:
                print(f"{name}: {line.strip()[:300]}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        launches = []
        for kernel in kernels:
            fn = getattr(lib, kernel.symbol)
            fn.argtypes = kernel.argtypes
            fn.restype = ctypes.c_int
            launches.append(_raising(name, fn))
        fns[name] = (lib, *launches)
    return fns


def _cases(which, fns, q, k, v, do, scale):
    """{name: (launches, outputs)} on one set of inputs, the plain version's
    outputs with their names, and the tensors that the launches read by
    address and that must therefore outlive them."""
    if which == "fwd":
        ref = _flash_fwd_plain(q, k, v, True, scale)
        runs = {}
        for name, (_, launch) in fns.items():
            fn, outs = _fwd_launcher(q, k, v, True, scale, launch)
            runs[name] = ((fn,), outs)
        return runs, ref, ("out", "lse"), ()
    out, lse = flash_attention_with_lse(q, k, v, causal=True)
    ref = _flash_bwd_plain(q, k, v, out, lse, do, True, scale)
    runs, keep = {}, [out, lse]
    for name, (_, dkv, dqk) in fns.items():
        dkv_fn, dq_fn, (delta, *grads) = _bwd_launchers(q, k, v, out, lse, do, scale, dkv, dqk)
        runs[name] = ((dkv_fn, dq_fn), grads)
        keep.append(delta)
    return runs, ref, ("dq", "dk", "dv"), keep


def _ragged_runs(fns, q, kp, vp, desc, kw, waves):
    """{name: ((launch,), (out,))} of each ragged version on one batch, the
    plain version's output, and the workspaces the launches write by
    address; `waves` maps a version's name to its split plan's blocks per
    SM."""
    hq, t, d = q.shape
    hkv, num_pages, ps, _ = kp.shape
    s_count, max_pages = desc[-1].shape
    groups, bq, mqb = hq // hkv, kw["block_q"], kw["max_q_blocks"]
    sm_scale = 1.0 / np.sqrt(d)
    q_scaled = (q.float() * sm_scale).to(q.dtype)
    ref = (ragged_reference_attention(q_scaled, kp, vp, *desc, **kw),)
    ptrs = [x.data_ptr() for x in (kp, vp, *desc)]
    stream = torch.cuda.current_stream().cuda_stream
    runs, keep = {}, []
    default_waves = ragged_mod._SPLIT_TARGET_WAVES
    for name, (lib, _) in fns.items():
        fn = lib.ragged_paged_attention_launch
        fn.argtypes = RAGGED.argtypes
        out = torch.zeros_like(q)
        ws, ws_ml, ws_acc, n_splits, per_split = None, 0, 0, 0, 0
        if q.dtype == torch.bfloat16 and mqb == 1:
            ragged_mod._SPLIT_TARGET_WAVES = waves.get(name, default_waves)
            try:
                ws, ws_ml, ws_acc, n_splits, per_split = _decode_workspace(
                    q, s_count, hkv, max_pages, ps, bq)
            finally:
                ragged_mod._SPLIT_TARGET_WAVES = default_waves
            print(f"ragged {name}: {n_splits} splits of {per_split} tiles", flush=True)
        args = (q.data_ptr(), *ptrs, out.data_ptr(), ws_acc, ws_ml, float(sm_scale),
                _DTYPE_CODES[q.dtype], d, t, num_pages, ps, max_pages, bq, groups, s_count,
                hkv, mqb, n_splits, per_split, stream)
        keep.append(ws)
        call = _raising(name, fn)
        runs[name] = ((lambda call=call, args=args: call(*args),), (out,))
    return runs, ref, keep


def _ragged_main(fns, timer, gen, waves) -> bool:
    """Each ragged version at chip_smoke's two cases: agreement with the
    plain version (bf16 at 2e-2), then times in the order A B ... B A."""
    ok = True
    order = list(fns) + list(fns)[::-1]
    for label, make in (("mixed", _ragged_case), ("decode", _ragged_decode_case)):
        q, kp, vp, desc, kw, _, _ = make(torch.bfloat16, gen)
        runs, ref, keep = _ragged_runs(fns, q, kp, vp, desc, kw, waves)
        for name, ((fn,), (out,)) in runs.items():
            fn()
            torch.cuda.synchronize()
            err = (out.float() - ref[0].float()).abs().max().item()
            good = torch.allclose(out.float(), ref[0].float(), atol=2e-2, rtol=2e-2)
            ok &= good
            print(f"ragged {label} {name}: {'agrees' if good else 'DISAGREES'} with the plain "
                  f"version, max_abs_err {err:.3e}", flush=True)
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(timer.ms(runs[name][0][0], ITERS))
        for name, slot in times.items():
            print(f"ragged {label} S={desc[0].numel()} max_q_blocks={kw['max_q_blocks']} {name}: "
                  "ms " + " ".join(f"{x:.4f}" for x in slot), flush=True)
        del runs, keep
    return ok


def _plain_ragged(q, k_pages, v_pages, starts, counts, q_lens, kv_lens, tables, *,
                  block_q: int = 8, sm_scale=None, max_q_blocks=None):
    """ragged_paged_attention's function on the plain version, whatever the
    device: q scaled and rounded as the dispatcher does, p kept in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if max_q_blocks is None:
        max_q_blocks = q.shape[1] // block_q
    q = (q.float() * scale).to(q.dtype)
    return ragged_reference_attention(q, k_pages, v_pages, starts, counts, q_lens, kv_lens,
                                      tables, block_q=block_q, max_q_blocks=max_q_blocks)


def _ragged_check_main() -> bool:
    """chip_smoke's serve and check phases on the ragged kernels, then on
    the plain version (patched into the serve passes); True when both
    checks pass."""
    kernels = paged.ragged_paged_attention
    results = {}
    for label, fn in (("kernels", kernels), ("plain", _plain_ragged)):
        paged.ragged_paged_attention = fn
        try:
            server, config, prompts, outs, split, _, _ = chip_smoke.phase_serve()
            try:
                results[label] = chip_smoke.phase_check(server, config, prompts, outs)
            finally:
                server.shutdown()
        except AssertionError as exc:
            print(f"ragged-check {label}: {exc}", flush=True)
        finally:
            paged.ragged_paged_attention = kernels
        server = None
        gc.collect()
        torch.cuda.empty_cache()
        if label in results:
            exact, total, worst = results[label]
            print(f"ragged-check {label} (ragged launches {split}): engine token == dense "
                  f"argmax at {exact} of {total}, worst gap {worst:.4f}", flush=True)
    return len(results) == 2


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "ragged-check":
        if not torch.cuda.is_available():
            print("torch_flash_ab: no CUDA device", file=sys.stderr)
            return 2
        print(_run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0])
        return 0 if _ragged_check_main() else 1
    if len(sys.argv) < 2 or sys.argv[1] not in SIDES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    which = sys.argv[1]
    source, kernels, timed = SIDES[which]
    print(_run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0])
    args, waves = sys.argv[2:], {}
    if which == "ragged" and args[:1] == ["--waves"]:
        waves = {f"repo_w{w}": int(w) for w in args[1].split(",")}
        args = args[2:]
    sources = {"repo": CSRC / source}
    sources.update({Path(p).stem: Path(p) for p in args})
    fns = _build(sources, kernels)
    ok = len(fns) == len(sources)
    for name in waves:  # the tree's library again, under another split plan
        fns[name] = fns["repo"]
    order = list(fns) + list(fns)[::-1]
    timer = _Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if which == "ragged":
        return 0 if _ragged_main(fns, timer, gen, waves) and ok else 1
    for label, shape in FLASH_SHAPES.items():
        q, k, v, do = _qkv_do(torch.bfloat16, gen, shape)
        runs, ref, names, keep = _cases(which, fns, q, k, v, do, 1.0 / np.sqrt(q.shape[-1]))
        for name, (launches, outs) in runs.items():
            for fn in launches:
                fn()
            torch.cuda.synchronize()
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(outs, ref)]
            # bf16 outputs at 2e-2 (one bf16 ulp at |x| ~ 1), the f32 lse at 1e-4
            good = all(torch.allclose(g.float(), r.float(), atol=tol, rtol=tol)
                       for g, r, tol in zip(outs, ref, [1e-4 if r.dtype == torch.float32 else 2e-2 for r in ref]))
            ok &= good
            print(f"{label} {name}: {'agrees' if good else 'DISAGREES'} with the plain version, max_abs_err "
                  + " ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)), flush=True)
        times = {name: [[] for _ in timed] for name in fns}
        for name in order:
            for slot, fn in zip(times[name], runs[name][0]):
                slot.append(timer.ms(fn, ITERS))
        b, hq, s, d = q.shape
        for name, slots in times.items():
            print(f"{label} B={b} GQA {hq}/{k.shape[1]} S={s} D={d} {name}: "
                  + " ".join(f"{n}_ms " + " ".join(f"{x:.4f}" for x in slot) for n, slot in zip(timed, slots)),
                  flush=True)
        del runs, keep
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
