"""Frozen model FLOP counts from a configuration file's sizes, and the
frozen work of a served request, for MFU and for K5's roofline.

A token's forward costs 2 operations per weight of every matrix product
(the blocks' projections and the LM head; embeddings and norms are
lookups and elementwise work, not counted) plus attention: 4 * D
operations per (query, key) pair and head (QK and PV), at the token's own
context. Training costs three forwards' worth (forward, and a backward of
twice the forward), recomputation not counted.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

from . import attention


def sizes(config: Dict[str, Any]) -> Dict[str, int]:
    """The sizes the counts need, from a configuration file's `model`."""
    m = config["model"]
    return {"d": m["d_model"], "layers": m["n_layers"], "hq": m["n_heads"],
            "hkv": m.get("n_kv_heads") or m["n_heads"], "ff": m["d_ff"], "vocab": m["vocab_size"],
            "head_dim": m["d_model"] // m["n_heads"], "gated": m["act"] == "swiglu"}


def matmul_params(config: Dict[str, Any]) -> int:
    """Weights of every matrix product a token goes through: q, k, v, o,
    the MLP (two or, gated, three matrices) in each layer, and the head."""
    s = sizes(config)
    d, hd = s["d"], s["head_dim"]
    attn = d * s["hq"] * hd * 2 + d * s["hkv"] * hd * 2
    mlp = (3 if s["gated"] else 2) * d * s["ff"]
    return s["layers"] * (attn + mlp) + d * s["vocab"]


def token_flops(config: Dict[str, Any], position: int) -> float:
    """One token's forward at 0-based `position` (position + 1 keys)."""
    s = sizes(config)
    return (2.0 * matmul_params(config)
            + 4.0 * s["layers"] * s["hq"] * s["head_dim"] * (position + 1))


def train_step_flops(config: Dict[str, Any], batch: int, seq: int) -> float:
    """Forward and backward of one step over (batch, seq) causal rows."""
    s = sizes(config)
    dense = 6.0 * matmul_params(config) * batch * seq
    attn = 3 * 4.0 * s["layers"] * s["hq"] * s["head_dim"] * batch * attention.causal_pairs(seq)
    return dense + attn


def prefill_chunks(prompt_len: int, cached: int, chunk: int) -> Iterable[Tuple[int, int]]:
    """(q_len, kv_len) of each chunk that prefills a prompt from its cached
    offset on, `chunk` tokens at a time."""
    offset = cached
    while offset < prompt_len:
        n = min(chunk, prompt_len - offset)
        yield n, offset + n
        offset += n


def serve_work(config: Dict[str, Any], prompt_len: int, cached: int, decode_positions:
               Iterable[int], chunk: int, prefill: bool) -> Dict[str, float]:
    """The frozen work of part of one request: its prompt's prefill from
    the cached offset (when `prefill`) and one decode step at each of
    `decode_positions` (the position of the token fed in). Returns model
    FLOPs and K5's operations, bytes and roofline-bound inputs, split into
    prefill chunks and decode steps, per layer summed over layers."""
    s = sizes(config)
    L = s["layers"]
    kw = dict(hq=s["hq"], hkv=s["hkv"], d=s["head_dim"], page_size=config["engine"]["page_size"])
    out = {"model_flops": 0.0, "k5_prefill_flops": 0.0, "k5_prefill_bytes": 0.0,
           "k5_decode_flops": 0.0, "k5_decode_bytes": 0.0, "k5_prefill_chunk_bound": []}
    if prefill:
        for q_len, kv_len in prefill_chunks(prompt_len, cached, chunk):
            f, b = attention.ragged_lane(q_len, kv_len, **kw)
            out["k5_prefill_flops"] += L * f
            out["k5_prefill_bytes"] += L * b
            out["k5_prefill_chunk_bound"].append((L * f, L * b))
        n = prompt_len - cached
        keys = attention.causal_pairs(prompt_len) - attention.causal_pairs(cached)
        out["model_flops"] += (2.0 * matmul_params(config) * n
                               + 4.0 * L * s["hq"] * s["head_dim"] * keys)
    for pos in decode_positions:
        f, b = attention.ragged_lane(1, pos + 1, **kw)
        out["k5_decode_flops"] += L * f
        out["k5_decode_bytes"] += L * b
        out["model_flops"] += token_flops(config, pos)
    return out
