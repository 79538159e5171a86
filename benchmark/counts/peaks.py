"""Published peaks of the chips the benchmark runs on, by the name that
`torch.cuda.get_device_name()` gives. NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the full 700 W power limit (a card set lower
runs slower under load; the run prints the limit beside its numbers)."""

from __future__ import annotations

from typing import Dict

H100_SXM = {
    "bf16_flops": 989e12,
    "fp16_flops": 989e12,
    "fp8_flops": 1979e12,
    "tf32_flops": 495e12,
    "f32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def bound_s(flops: float, nbytes: float, peak: Dict[str, float],
            dtype: str = "bf16") -> float:
    """The least time a call could take: the larger of its operations over
    the peak rate of `dtype` and its bytes over the memory bandwidth."""
    return max(flops / peak[f"{dtype}_flops"], nbytes / peak["hbm_bytes_per_s"])
