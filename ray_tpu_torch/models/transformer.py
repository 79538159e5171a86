"""Decoder-only transformer covering the GPT-2 and Llama families.

Port of `ray_tpu/models/transformer.py`: the full-sequence forward (for
training and the dense check), and the dense-cache `init_cache` /
`prefill` / `decode_step` that the dense `LLMEngine` and the draft-model
proposer of speculative decoding run. Parameters are a plain dict of tensors
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

Shapes: tokens (B, S) int → logits (B, S, V). The dense KV cache is
(L, B, Hkv, max_seq, Dh), as in the JAX package.
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


def logical_axes(config: TransformerConfig) -> Params:
    """Logical-axis tree mirroring init_params output (the sharding rules'
    input, `parallel/sharding.py`)."""
    c = config
    blocks: Params = {
        "ln1_scale": ("layers", None),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "ln2_scale": ("layers", None),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    if c.act == "swiglu":
        blocks["w_gate"] = ("layers", "embed", "mlp")
    if c.norm == "layernorm":
        blocks["ln1_bias"] = ("layers", None)
        blocks["ln2_bias"] = ("layers", None)
    if c.use_bias:
        blocks["bq"] = ("layers", "heads", "head_dim")
        blocks["bk"] = ("layers", "kv_heads", "head_dim")
        blocks["bv"] = ("layers", "kv_heads", "head_dim")
        blocks["bo"] = ("layers", None)
        blocks["b_up"] = ("layers", "mlp")
        blocks["b_down"] = ("layers", None)
    axes: Params = {
        "wte": ("vocab", "embed"),
        "blocks": blocks,
        "lnf_scale": (None,),
    }
    if c.pos_emb == "learned":
        axes["wpe"] = (None, "embed")
    if c.norm == "layernorm":
        axes["lnf_bias"] = (None,)
    if not c.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


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


# --------------------------------------------------------------------- decode


def init_cache(
    config: TransformerConfig,
    batch: int,
    max_seq: Optional[int] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Dense KV cache: k/v of shape (L, B, Hkv, S, Dh) in the compute dtype."""
    c = config
    s = max_seq or c.max_seq
    shape = (c.n_layers, batch, c.kv_heads, s, c.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
            "v": torch.zeros(shape, dtype=c.dtype, device=dev)}


def prefill(
    params: Params,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    cache: Params,
    config: TransformerConfig,
) -> Tuple[torch.Tensor, Params]:
    """Prompt ingestion: run the full-sequence path once, write K/V into
    the first S slots of the cache (in place; the same dict is returned)
    and return each row's last-valid-token logits. tokens (B, S)
    right-padded; lengths (B,) true prompt lengths. Attention is
    `flash_attention(causal=True)`: the flash forward kernel on the card."""
    c = config
    dt = c.dtype
    s = tokens.shape[1]
    x = embed(params, tokens, c)
    if c.pos_emb == "learned":
        x = x + params["wpe"][:s].to(dt)[None]
        rope_tables = None
    else:
        rope_tables = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=x.device)
    for i in range(c.n_layers):
        lp = layer_params(params, i)
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
            q = apply_rope(q, cos, sin, None)
            k = apply_rope(k, cos, sin, None)
        # the padded tail is masked by `lengths` when the cache is read
        cache["k"][i, :, :, :s] = k.to(c.dtype)
        cache["v"][i, :, :, :s] = v.to(c.dtype)
        attn = flash_attention(q, k, v, causal=True, implementation=c.attn_impl)
        b = attn.shape[0]
        out = attn.transpose(1, 2).reshape(b, s, -1) @ lp["wo"].to(dt).reshape(-1, c.d_model)
        if c.use_bias:
            out = out + lp["bo"].to(dt)
        x = mlp_sublayer(x + out, lp, c)
    x = _norm(x, params["lnf_scale"], params.get("lnf_bias"), c.norm)
    last = x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1]  # (B, E)
    return last @ lm_head_weights(params, c), cache


def _decode_attention(q, k_cache, v_cache, lengths):
    """Single-step attention against the cache. q (B, Hq, 1, Dh); cache
    (B, Hkv, S, Dh); lengths (B,) = #valid cache slots per example.

    GQA runs through a grouped view: the G = Hq / Hkv query heads of a kv
    head are the rows of one (G, Dh) x (Dh, S) product, so the cache is
    read once, never repeated per query head. Scores are f32 (on the card
    the bf16 product writes f32 out), masked to -1e30 past each example's
    length, softmaxed in f32 and cast to the cache's dtype for P.V."""
    b, hq, _, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b * hkv, g, dh)
    kt = k_cache.reshape(b * hkv, s, dh).transpose(1, 2)
    if qg.dtype == torch.float32:
        scores = torch.bmm(qg, kt)
    else:
        scores = torch.bmm(qg, kt, out_dtype=torch.float32)
    scores = scores.view(b, hkv, g, s) / math.sqrt(dh)
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]  # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.bmm(probs.view(b * hkv, g, s), v_cache.reshape(b * hkv, s, dh))
    return out.view(b, hq, 1, dh)


def decode_step(
    params: Params,
    cache: Params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    config: TransformerConfig,
    *,
    rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Params]:
    """One autoregressive step for continuous batching.

    tokens (B,) int; positions (B,) int — per-example write slot (also the
    rope position). Returns (logits (B, V), the cache updated in place).
    Examples at different sequence positions coexist in one batch: each
    writes its own cache row at its own position. `rope_tables` (cos, sin)
    may be computed once by the caller (a captured graph closes over
    them)."""
    c = config
    dt = c.dtype
    b = tokens.shape[0]
    dev = tokens.device
    positions = positions.long()
    x = embed(params, tokens, c)[:, None, :]  # (B, 1, E)
    if c.pos_emb == "learned":
        x = x + params["wpe"][positions].to(dt)[:, None, :]
        rope_tables = None
    elif rope_tables is None:
        rope_tables = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=dev)
    lengths = positions + 1
    lanes = torch.arange(b, device=dev)
    for i in range(c.n_layers):
        lp = layer_params(params, i)
        h = _norm(x, lp["ln1_scale"], lp.get("ln1_bias"), c.norm)
        q = _heads(h, lp["wq"].to(dt))  # (B, H, 1, Dh)
        k = _heads(h, lp["wk"].to(dt))
        v = _heads(h, lp["wv"].to(dt))
        if c.use_bias:
            q = q + lp["bq"].to(dt)[None, :, None, :]
            k = k + lp["bk"].to(dt)[None, :, None, :]
            v = v + lp["bv"].to(dt)[None, :, None, :]
        if rope_tables is not None:
            cos, sin = rope_tables
            pos2d = positions[:, None]
            q = apply_rope(q, cos, sin, pos2d)
            k = apply_rope(k, cos, sin, pos2d)
        # each example's new row at its own position, in place
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[lanes, :, positions] = k[:, :, 0].to(c.dtype)
        v_cache[lanes, :, positions] = v[:, :, 0].to(c.dtype)
        attn = _decode_attention(q, k_cache, v_cache, lengths)
        out = attn.to(dt).reshape(b, 1, -1) @ lp["wo"].to(dt).reshape(-1, c.d_model)
        if c.use_bias:
            out = out + lp["bo"].to(dt)
        x = mlp_sublayer(x + out, lp, c)
    x = _norm(x, params["lnf_scale"], params.get("lnf_bias"), c.norm)
    return (x @ lm_head_weights(params, c))[:, 0], cache
