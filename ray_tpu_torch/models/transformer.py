"""Decoder-only transformer covering the GPT-2 and Llama families.

Port of `ray_tpu/models/transformer.py` (the full-sequence forward, for
training and the dense check; the dense-cache `decode_step`/`prefill`/
`init_cache` are not ported yet). Parameters are a plain dict of tensors
in the JAX layout — block weights stacked on a leading layer axis,
attention weights as (E, H, Dh) / (H, Dh, E) — so a JAX parameter pytree
converts leaf for leaf (`models.convert.params_from_numpy`). The layer
stack is a Python loop over that axis; attention runs through
`ops.flash_attention` (the CUDA kernels on the card, forward and
backward; their plain versions on the CPU), or `mha_reference` when
`attn_impl="xla"`. `remat=True` wraps each block in
`torch.utils.checkpoint` (the counterpart of `jax.checkpoint` on the scan
body) while gradients are being recorded.

Two fields of the JAX config have no counterpart here: `fused_qkv` (the
same math as one wider product; a performance choice for the MXU) and
`scan_unroll` (the unroll of `lax.scan` over layers; eager PyTorch runs
no scan).

Shapes: tokens (B, S) int → logits (B, S, V).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops import (
    apply_rope,
    flash_attention,
    gelu,
    layernorm,
    rmsnorm,
    rope_frequencies,
    swiglu,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: Optional[int] = None  # None → n_heads (MHA); < n_heads → GQA
    d_ff: int = 3072
    max_seq: int = 1024
    pos_emb: str = "learned"  # "learned" (GPT-2) | "rope" (Llama)
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    act: str = "gelu"  # "gelu" | "swiglu"
    use_bias: bool = True
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False  # recompute each block in the backward
    attn_impl: Optional[str] = None  # None/"pallas"/"pallas_pipelined" → flash kernels; "xla" → reference
    causal: bool = True  # False → bidirectional encoder

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------- init


def init_params(
    config: TransformerConfig,
    seed: int = 0,
    *,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> Params:
    """GPT-2-style init: N(0, 0.02), residual-out projections scaled by
    1/sqrt(2L), block params stacked on a leading layer axis. Drawn on
    `device` from `generator` (a torch.Generator on that device; seeded
    from `seed` when not given). The distributions match the JAX init; the
    bits do not (torch and jax.random are different generators)."""
    c = config
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    pd = c.param_dtype
    dh = c.head_dim
    std = 0.02
    res_std = std / math.sqrt(2 * c.n_layers)

    def normal(shape, s=std):
        return torch.empty(shape, dtype=pd, device=dev).normal_(0.0, s, generator=generator)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    L = c.n_layers
    blocks: Params = {
        "ln1_scale": ones((L, c.d_model)),
        "wq": normal((L, c.d_model, c.n_heads, dh)),
        "wk": normal((L, c.d_model, c.kv_heads, dh)),
        "wv": normal((L, c.d_model, c.kv_heads, dh)),
        "wo": normal((L, c.n_heads, dh, c.d_model), res_std),
        "ln2_scale": ones((L, c.d_model)),
        "w_up": normal((L, c.d_model, c.d_ff)),
        "w_down": normal((L, c.d_ff, c.d_model), res_std),
    }
    if c.act == "swiglu":
        blocks["w_gate"] = normal((L, c.d_model, c.d_ff))
    if c.norm == "layernorm":
        blocks["ln1_bias"] = zeros((L, c.d_model))
        blocks["ln2_bias"] = zeros((L, c.d_model))
    if c.use_bias:
        blocks["bq"] = zeros((L, c.n_heads, dh))
        blocks["bk"] = zeros((L, c.kv_heads, dh))
        blocks["bv"] = zeros((L, c.kv_heads, dh))
        blocks["bo"] = zeros((L, c.d_model))
        blocks["b_up"] = zeros((L, c.d_ff))
        blocks["b_down"] = zeros((L, c.d_model))

    params: Params = {
        "wte": normal((c.vocab_size, c.d_model)),
        "blocks": blocks,
        "lnf_scale": ones((c.d_model,)),
    }
    if c.pos_emb == "learned":
        params["wpe"] = normal((c.max_seq, c.d_model), 0.01)
    if c.norm == "layernorm":
        params["lnf_bias"] = zeros((c.d_model,))
    if not c.tie_embeddings:
        params["lm_head"] = normal((c.d_model, c.vocab_size))
    return params


def count_params(params: Params) -> int:
    """Number of parameters (elements over every leaf)."""
    return sum(count_params(v) if isinstance(v, dict) else v.numel() for v in params.values())


def layer_params(params: Params, i: int) -> Params:
    """Layer i's weights: views into the stacked block tensors."""
    return {name: w[i] for name, w in params["blocks"].items()}


# -------------------------------------------------------------------- forward


def _norm(x, scale, bias, kind):
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    return layernorm(x, scale, bias)


def _heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bse,ehd->bhsd' as one matrix product."""
    b, s, e = h.shape
    return (h @ w.reshape(e, -1)).view(b, s, w.shape[1], w.shape[2]).transpose(1, 2)


def attention_sublayer(
    x: torch.Tensor,
    lp: Params,
    config: TransformerConfig,
    rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]],
    positions: Optional[torch.Tensor],
) -> torch.Tensor:
    """Pre-norm self-attention (causal unless the config says not) +
    residual on (B, S, E)."""
    c = config
    dt = c.dtype
    h = _norm(x, lp["ln1_scale"], lp.get("ln1_bias"), c.norm)
    q = _heads(h, lp["wq"].to(dt))
    k = _heads(h, lp["wk"].to(dt))
    v = _heads(h, lp["wv"].to(dt))
    if c.use_bias:
        q = q + lp["bq"].to(dt)[None, :, None, :]
        k = k + lp["bk"].to(dt)[None, :, None, :]
        v = v + lp["bv"].to(dt)[None, :, None, :]
    if rope_tables is not None:
        cos, sin = rope_tables
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    attn = flash_attention(q, k, v, causal=c.causal, implementation=c.attn_impl)  # (B, H, S, D)
    b, _, s, _ = attn.shape
    out = attn.transpose(1, 2).reshape(b, s, -1) @ lp["wo"].to(dt).reshape(-1, c.d_model)
    if c.use_bias:
        out = out + lp["bo"].to(dt)
    return x + out


def mlp_sublayer(x: torch.Tensor, lp: Params, config: TransformerConfig) -> torch.Tensor:
    """Pre-norm dense MLP + residual on (..., E)."""
    c = config
    dt = c.dtype
    h = _norm(x, lp["ln2_scale"], lp.get("ln2_bias"), c.norm)
    up = h @ lp["w_up"].to(dt)
    if c.use_bias:
        up = up + lp["b_up"].to(dt)
    if c.act == "swiglu":
        act = swiglu(h @ lp["w_gate"].to(dt), up)
    else:
        act = gelu(up)
    down = act @ lp["w_down"].to(dt)
    if c.use_bias:
        down = down + lp["b_down"].to(dt)
    return x + down


def _block(x, lp, config, rope_tables, positions):
    """One transformer block on (B, S, E) activations."""
    x = attention_sublayer(x, lp, config, rope_tables, positions)
    return mlp_sublayer(x, lp, config)


def embed(params: Params, tokens: torch.Tensor, config: TransformerConfig) -> torch.Tensor:
    """Token embedding rows in the compute dtype (gathered, then cast)."""
    return params["wte"][tokens.long()].to(config.dtype)


def forward_hidden(
    params: Params,
    tokens: torch.Tensor,
    config: TransformerConfig,
    *,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward up to (but excluding) the LM head: (B, S) → (B, S, E)."""
    c = config
    dt = c.dtype
    s = tokens.shape[1]
    x = embed(params, tokens, c)
    if c.pos_emb == "learned":
        if positions is None:
            x = x + params["wpe"][:s].to(dt)[None]
        else:
            x = x + params["wpe"][positions.long()].to(dt)
        rope_tables = None
    else:
        rope_tables = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=x.device)
    remat = c.remat and torch.is_grad_enabled()
    for i in range(c.n_layers):
        lp = layer_params(params, i)
        if remat:
            x = checkpoint(_block, x, lp, c, rope_tables, positions, use_reentrant=False)
        else:
            x = _block(x, lp, c, rope_tables, positions)
    return _norm(x, params["lnf_scale"], params.get("lnf_bias"), c.norm)


def lm_head_weights(params: Params, config: TransformerConfig) -> torch.Tensor:
    """(E, V) output projection — tied to wte unless a separate lm_head
    exists."""
    head = params.get("lm_head", None)
    if head is None:
        head = params["wte"].T
    return head.to(config.dtype)


def forward(
    params: Params,
    tokens: torch.Tensor,
    config: TransformerConfig,
    *,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence forward: (B, S) → (B, S, V)."""
    x = forward_hidden(params, tokens, config, positions=positions)
    return x @ lm_head_weights(params, config)
