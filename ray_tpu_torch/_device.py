"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; without a
    CUDA device this raises rather than dropping to the CPU, so a run
    never measures the plain path while believing it measured a kernel.
    Callers that want the plain CPU path ask for it with device="cpu".
    "meta" (shapes only, no data) is what the cost layer counts a step on
    (`util/profiling.step_cost`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
