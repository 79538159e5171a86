"""Collective accounting.

Port of `dp_sync_bytes` from `ray_tpu/parallel/collectives.py`: the
ring-collective arithmetic behind JAX's `dp_sync_bytes` report key and
its dp_sync estimate. The port's trainer runs one replica, where both
are 0; it reads this once the mesh spans devices, and the collectives
themselves (the int8 block-quantized all-reduce and reduce-scatter, the
group manager) come with that mesh (ROADMAP A7).
"""

from __future__ import annotations


def dp_sync_bytes(
    n_params: int,
    n_replicas: int,
    *,
    mode: str = "f32",
    shard_update: bool = False,
    block: int = 512,
    param_bytes: int = 4,
) -> int:
    """Per-replica wire bytes one data-parallel sync moves per step (ring
    collective accounting: each stage ships (n-1)/n of the payload)."""
    if n_replicas <= 1:
        return 0
    f = (n_replicas - 1) / n_replicas
    scales = 4 * -(-n_params // block)
    if mode == "int8":
        grad_stage = f * (n_params + scales)          # int8 values + f32 scales
        gather_stage = f * (n_params + scales)
    else:
        grad_stage = f * n_params * param_bytes       # reduce-scatter half
        gather_stage = f * n_params * param_bytes     # all-gather half
    if shard_update:
        # grads only reduce-scatter; the gather ships updated params f32
        return int(grad_stage + f * n_params * param_bytes)
    return int(grad_stage + gather_stage)
