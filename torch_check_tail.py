#!/usr/bin/env python3
"""The serve path's teacher-forced gap over many generated positions.

    python3 torch_check_tail.py [NEW_TOKENS]

Serves chip_smoke.py's 8 greedy Llama-3-8B requests (prompts 64-900
tokens, random bf16 weights from its seed) with NEW_TOKENS new tokens each
(default 120: the longest prompt then fills its 1024-token slot) on the
paged engine with every pass captured as a CUDA graph, first on the ragged
kernels, then with their plain version in their place (p kept in f32),
and runs chip_smoke.py's dense check on every generated position of every
request: the worst gap of an engine token below the dense argmax, where it
sits, the row's largest logit, and the positions over CHECK_MARGIN. A gap
over the margin is printed, not raised. Needs one CUDA device.
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

import chip_smoke
import torch_flash_ab
from ray_tpu_torch.models import get_config, init_params
from ray_tpu_torch.serve.llm import PagedConfig, PagedEngineConfig, PagedLLMEngine, paged


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_check_tail: no CUDA device", file=sys.stderr)
        return 2
    new_tokens = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    chip_smoke.phase_env()
    chip_smoke.phase_build()
    config = get_config(chip_smoke.MODEL).replace(param_dtype=torch.bfloat16)
    params = init_params(config, chip_smoke.SEED, device="cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    lengths = np.linspace(64, 900, chip_smoke.N_REQUESTS).astype(int)
    prompts = [rng.integers(0, config.vocab_size, n).tolist() for n in lengths]
    kernels = paged.ragged_paged_attention
    for label, fn in (("kernels", kernels), ("plain", torch_flash_ab._plain_ragged)):
        paged.ragged_paged_attention = fn
        try:
            engine = PagedLLMEngine(config, params, PagedEngineConfig(
                max_slots=chip_smoke.N_REQUESTS, precompile=True, paged=PagedConfig()),
                device="cuda")
            streams = [engine.submit(p, max_tokens=new_tokens) for p in prompts]
            outs = [s.result(timeout=900) for s in streams]
            engine.shutdown()
        finally:
            paged.ragged_paged_attention = kernels
        try:
            chip_smoke._dense_check(f"tail {label}", params, config, prompts, outs,
                                    picks=list(range(len(prompts))), labels=[label] * len(prompts))
        except AssertionError as exc:
            print(f"[tail {label}] {exc}", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
