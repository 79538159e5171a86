#!/usr/bin/env python3
"""Compare versions of a flash-attention kernel source on one GPU.

    python3 torch_flash_ab.py fwd|bwd [OTHER.cu ...]

Builds ray_tpu_torch/ops/csrc/flash_attention_fwd.cu (or _bwd.cu) as
"repo" and each OTHER.cu (a variant of it, e.g. `git show REV:path >
old.cu`; it finds the headers of csrc/) with the port's nvcc flags, one
process per source started together, prints each build's registers and
spills for the bf16 (wgmma) instances and any ptxas note about wgmma
(C75xx), holds each version's outputs against the plain version
(`_flash_fwd_plain`: out and lse; `_flash_bwd_plain`: dq, dk, dv) at
chip_smoke.py's flash shapes (GPT-2 124M train shape, Llama GQA shape;
bf16, causal), and times each version's launches on the same inputs in
the order A B ... B A, so that drift of the card shows as a difference
between a version's two readings. Times are medians of per-launch CUDA
events with the L2 flushed (chip_smoke's `_Timer`). Needs one CUDA
device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import FLASH_SHAPES, _bwd_launchers, _fwd_launcher, _qkv_do, _run, _Timer
from ray_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from ray_tpu_torch.ops.attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    _flash_bwd_plain,
    _flash_fwd_plain,
    flash_attention_with_lse,
)

ITERS = 20
# which -> (source, the kernels bound to it, the names of their outputs' times)
SIDES = {
    "fwd": ("flash_attention_fwd.cu", (FLASH_FWD,), ("fwd",)),
    "bwd": ("flash_attention_bwd.cu", (FLASH_BWD_DKV, FLASH_BWD_DQ), ("dkv", "dq")),
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
                kind = entry.split("flash_", 1)[1].split("EEEv", 1)[0]
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


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in SIDES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    which = sys.argv[1]
    source, kernels, timed = SIDES[which]
    print(_run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0])
    sources = {"repo": CSRC / source}
    sources.update({Path(p).stem: Path(p) for p in sys.argv[2:]})
    fns = _build(sources, kernels)
    order = list(fns) + list(fns)[::-1]
    timer = _Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = len(fns) == len(sources)
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
