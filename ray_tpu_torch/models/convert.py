"""Weight carry: a JAX parameter pytree (as numpy arrays) → torch tensors.

The tree has the layout `ray_tpu.models.init_params` produces:
{"wte", "blocks": {...stacked on L...}, "lnf_scale", ["lnf_bias"],
["wpe"], ["lm_head"]}. Matrix weights are stored in the compute dtype,
which is exactly what the JAX code computes with after its `.astype(dt)`;
norm scales and biases stay float32 (the JAX code reads norm scales in
float32 and casts biases itself).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from .transformer import TransformerConfig

# leaves the JAX forward multiplies in the compute dtype
MATRIX_KEYS = frozenset(
    {"wte", "wpe", "lm_head", "wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate"}
)


def _tensor(name: str, value: Any, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    # via float32: exact for bf16/f16 leaves, which numpy may not carry
    out = torch.from_numpy(np.ascontiguousarray(np.asarray(value).astype(np.float32)))
    target = dtype if name in MATRIX_KEYS else torch.float32
    return out.to(device=dev, dtype=target)


def params_from_numpy(
    tree: Mapping[str, Any],
    config: TransformerConfig,
    device: Union[str, torch.device] = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Convert the JAX parameter pytree (numpy leaves) to the port's
    parameter dict on `device`. Matrix weights go to `dtype` (default: the
    config's compute dtype); norm scales and biases stay float32."""
    dev = resolve_device(device)
    dt = dtype or config.dtype
    out: Dict[str, Any] = {}
    for name, value in tree.items():
        if name == "blocks":
            out[name] = {k: _tensor(k, v, dt, dev) for k, v in value.items()}
        else:
            out[name] = _tensor(name, value, dt, dev)
    return out
