"""Weight carry: a JAX parameter pytree (as numpy arrays) → torch tensors.

The tree has the layout `ray_tpu.models.init_params` produces:
{"wte", "blocks": {...stacked on L...}, "lnf_scale", ["lnf_bias"],
["wpe"], ["lm_head"]}, or the MoE model's (`models/moe.py`: the blocks
hold `router` and the expert stacks `we_gate` / `we_up` / `we_down`) or
ViT's and CLIP's (`models/vit.py`: nested trees, converted key for key).
Matrix weights are stored in the compute dtype,
which is exactly what the JAX code computes with after its `.astype(dt)`;
norm scales and biases stay float32 (the JAX code reads norm scales in
float32 and casts biases itself).

Training keeps f32 master weights, as the JAX train state does: carry
them with `params_from_numpy(tree, config, dtype=torch.float32)`. The
forward's `.to(config.dtype)` then makes the compute-dtype copy on every
step, as JAX's `.astype(dt)` does, and the gradients reach the f32
masters through that cast.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from .transformer import TransformerConfig

# leaves the JAX forward multiplies in the compute dtype
MATRIX_KEYS = frozenset(
    {"wte", "wpe", "lm_head", "wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate",
     "we_gate", "we_up", "we_down", "patch_proj", "head"}
)
# the MoE router is read in f32 (`moe_mlp_sublayer`), as JAX reads it


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
    return _convert(tree, dtype or config.dtype, dev)


def _convert(tree: Mapping[str, Any], dt: torch.dtype, dev: torch.device) -> Dict[str, Any]:
    return {name: _convert(value, dt, dev) if isinstance(value, Mapping)
            else _tensor(name, value, dt, dev) for name, value in tree.items()}
