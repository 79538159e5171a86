#!/usr/bin/env python3
"""Compare versions of the flash backward source on one GPU.

    python3 torch_bwd_ab.py [OTHER.cu ...]

Builds ray_tpu_torch/ops/csrc/flash_attention_bwd.cu ("repo") and each
OTHER.cu (a variant of it, e.g. `git show REV:path > old.cu`) with the
port's nvcc flags, one process per source started together, prints each
build's registers and spills for the wgmma instances, holds each
version's dq, dk and dv against `_flash_bwd_plain` at chip_smoke.py's
backward shapes (GPT-2 124M train shape, Llama GQA shape; bf16, causal),
and times each version's dkv and dq launches on the same inputs in the
order A B ... B A, so that drift of the card shows as a difference
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

from chip_smoke import BWD_SHAPES, _bwd_launchers, _qkv_do, _run, _Timer
from ray_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from ray_tpu_torch.ops.attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    _flash_bwd_plain,
    flash_attention_with_lse,
)

ITERS = 20


def _raising(name: str, fn):
    def call(*args):
        if fn(*args):
            raise RuntimeError(f"{name}: launch failed")
    return call


def _build(sources: dict) -> dict:
    """{name: (library, dkv launch, dq launch)} of every source that
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
            elif "wgmma" in entry and ("Used" in line or "spill stores" in line):
                kind = entry.split("flash_bwd_", 1)[1].split("EEEv", 1)[0]
                print(f"{name}: {kind}: {line.split('info    :', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        pair = []
        for symbol, kernel in (("flash_attention_bwd_dkv_launch", FLASH_BWD_DKV),
                               ("flash_attention_bwd_dq_launch", FLASH_BWD_DQ)):
            fn = getattr(lib, symbol)
            fn.argtypes = kernel.argtypes
            fn.restype = ctypes.c_int
            pair.append(_raising(name, fn))
        fns[name] = (lib, *pair)
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    print(_run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0])
    sources = {"repo": CSRC / "flash_attention_bwd.cu"}
    sources.update({Path(p).stem: Path(p) for p in sys.argv[1:]})
    fns = _build(sources)
    order = list(fns) + list(fns)[::-1]
    timer = _Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = True
    for label, shape in BWD_SHAPES.items():
        q, k, v, do = _qkv_do(torch.bfloat16, gen, shape)
        scale = 1.0 / np.sqrt(q.shape[-1])
        out, lse = flash_attention_with_lse(q, k, v, causal=True)
        ref = _flash_bwd_plain(q, k, v, out, lse, do, True, scale)
        runs = {}
        for name, (_, dkv, dqk) in fns.items():
            dkv_fn, dq_fn, keep = _bwd_launchers(q, k, v, out, lse, do, scale, dkv, dqk)
            runs[name] = (dkv_fn, dq_fn, keep)
            dkv_fn()
            dq_fn()
            torch.cuda.synchronize()
            grads = keep[1:]
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref)]
            good = all(torch.allclose(g.float(), r.float(), atol=2e-2, rtol=2e-2) for g, r in zip(grads, ref))
            ok &= good
            print(f"{label} {name}: {'agrees' if good else 'DISAGREES'} with _flash_bwd_plain "
                  f"(atol = rtol = 2e-2), max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}",
                  flush=True)
        times = {name: ([], []) for name in fns}
        for name in order:
            times[name][0].append(timer.ms(runs[name][0], ITERS))
            times[name][1].append(timer.ms(runs[name][1], ITERS))
        b, hq, s, d = q.shape
        for name, (t_dkv, t_dq) in times.items():
            print(f"{label} B={b} GQA {hq}/{k.shape[1]} S={s} D={d} {name}: dkv_ms "
                  + " ".join(f"{x:.4f}" for x in t_dkv) + " dq_ms " + " ".join(f"{x:.4f}" for x in t_dq),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
