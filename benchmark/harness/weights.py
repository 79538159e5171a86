"""Weights made from the seed, on the device, in a few large calls.

The benchmark makes the weights itself and hands the same tensors to the
program and, once the program is done, to the plain reference. They are
laid out as the port takes them (`ray_tpu_torch.models.transformer`:
block weights stacked on a leading layer axis, attention weights as
(E, H, Dh) / (H, Dh, E)) and drawn as its own init draws them: N(0, 0.02),
the residual-out projections at 0.02 / sqrt(2 L), learned positions at
0.01, norm scales 1 and biases 0. All draws come from one normal fill of
one flat buffer, from a `torch.Generator` on the device seeded with the
run's seed, so a seed gives the same weights on every run.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def layout(m: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(path, shape, init, std) of every leaf for a configuration file's
    `model` group; init is "normal", "ones" or "zeros"."""
    L, E, H = m["n_layers"], m["d_model"], m["n_heads"]
    Hkv = m.get("n_kv_heads") or H
    Dh, F, V = E // H, m["d_ff"], m["vocab_size"]
    std, res = 0.02, 0.02 / math.sqrt(2 * L)
    out = [
        ("blocks/ln1_scale", (L, E), "ones", 0.0),
        ("blocks/wq", (L, E, H, Dh), "normal", std),
        ("blocks/wk", (L, E, Hkv, Dh), "normal", std),
        ("blocks/wv", (L, E, Hkv, Dh), "normal", std),
        ("blocks/wo", (L, H, Dh, E), "normal", res),
        ("blocks/ln2_scale", (L, E), "ones", 0.0),
        ("blocks/w_up", (L, E, F), "normal", std),
        ("blocks/w_down", (L, F, E), "normal", res),
    ]
    if m["act"] == "swiglu":
        out.append(("blocks/w_gate", (L, E, F), "normal", std))
    if m["norm"] == "layernorm":
        out += [("blocks/ln1_bias", (L, E), "zeros", 0.0), ("blocks/ln2_bias", (L, E), "zeros", 0.0)]
    if m["use_bias"]:
        out += [("blocks/bq", (L, H, Dh), "zeros", 0.0), ("blocks/bk", (L, Hkv, Dh), "zeros", 0.0),
                ("blocks/bv", (L, Hkv, Dh), "zeros", 0.0), ("blocks/bo", (L, E), "zeros", 0.0),
                ("blocks/b_up", (L, F), "zeros", 0.0), ("blocks/b_down", (L, E), "zeros", 0.0)]
    out += [("wte", (V, E), "normal", std), ("lnf_scale", (E,), "ones", 0.0)]
    if m["pos_emb"] == "learned":
        out.append(("wpe", (m["max_seq"], E), "normal", 0.01))
    if m["norm"] == "layernorm":
        out.append(("lnf_bias", (E,), "zeros", 0.0))
    if not m["tie_embeddings"]:
        out.append(("lm_head", (E, V), "normal", std))
    return out


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**64 - 1))
    return gen


def make(m: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    """The weight tree for `model` group `m`, in its `param_dtype`, on
    `device`. Every leaf is a view of one buffer."""
    dtype = DTYPES[m["param_dtype"]]
    leaves = layout(m)
    normal = [(p, s, sd) for p, s, init, sd in leaves if init == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, 1.0, generator=generator(seed, device))
    tree: Dict[str, Any] = {"blocks": {}}
    offset = 0
    for path, shape, init, sd in leaves:
        if init == "normal":
            n = math.prod(shape)
            leaf = flat[offset:offset + n].view(shape)
            leaf.mul_(sd)
            offset += n
        elif init == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        else:
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        node = tree["blocks"] if path.startswith("blocks/") else tree
        node[path.split("/")[-1]] = leaf
    return tree


def flat_leaves(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"blocks/wq": tensor, "wte": tensor, ...}"""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out
