"""Mixture-of-Experts transformer (Mixtral family) with expert parallelism.

Port of `ray_tpu/models/moe.py`. The dense skeleton is the transformer's
(`models/transformer.py`), with each block's MLP replaced by E expert
MLPs stacked on an "expert" axis (`we_gate` / `we_up` / `we_down`,
(L, E, ...)) and a router (`router`, (L, d_model, E), used in f32).
Routing is GShard's dense dispatch / combine with top-k and a capacity:
a token over its expert's capacity falls through on the residual path,
and the Switch load-balancing loss keeps experts busy.

Under a mesh (`spmd`, `parallel.spmd.ModelSharding`) the "expert" axis
splits over ep by the rule `("expert", "ep")`: a rank holds E / ep
experts. JAX leaves the e-sharded einsums to GSPMD; the port writes the
collectives out. The batch is not split over ep (the default rules split
it over dp and fsdp), so each ep rank dispatches its copy of the tokens
to its own experts and the combine's partial sums are summed over ep:
Megatron's `enter` on the tokens and on the gate weights (identity
forward, all-reduce of the gradient) and `leave` on the partial output
(all-reduce forward). The router, the dispatch and the aux loss run
whole on every ep rank, so the replicated weights' gradients come out
equal on every ep rank, each counted once. Over the data axes the aux
loss is the global batch's, as in JAX: its two means are summed over the
data axes (`ModelSharding.data_reduce`) before their product.

`jax.lax.top_k` and `torch.topk` may order equal probabilities
differently; router probabilities from random f32 inputs have no ties.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops import cross_entropy_loss, rope_frequencies, swiglu
from .transformer import (
    Params,
    TransformerConfig,
    _norm,
    attention_sublayer,
    embed,
    init_params as _dense_init,
    layer_params,
    lm_head_weights,
    logical_axes as _dense_axes,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    router_aux_coeff: float = 0.01


def mixtral_8x7b() -> MoEConfig:
    """Mixtral 8x7B (expert parallelism)."""
    return MoEConfig(
        vocab_size=32000,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        max_seq=8192,
        pos_emb="rope",
        norm="rmsnorm",
        act="swiglu",
        use_bias=False,
        tie_embeddings=False,
        rope_theta=1e6,
        remat=True,
        n_experts=8,
        top_k=2,
    )


def moe_tiny() -> MoEConfig:
    """4-layer 4-expert toy (divisible by ep=2 / tp=2 test meshes)."""
    return MoEConfig(
        vocab_size=256,
        d_model=64,
        n_layers=4,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        max_seq=128,
        pos_emb="rope",
        norm="rmsnorm",
        act="swiglu",
        use_bias=False,
        tie_embeddings=False,
        dtype=torch.float32,
        n_experts=4,
        top_k=2,
    )


# ----------------------------------------------------------------------- init

_DENSE_MLP = ("w_up", "w_down", "w_gate", "b_up", "b_down")


def init_params(
    config: MoEConfig,
    seed: int = 0,
    *,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> Params:
    """Dense skeleton + per-expert MLP stacks (L, E, ...), N(0, 0.02) with
    the down projections at 0.02 / sqrt(2L), as JAX's init draws them
    (the bits differ: another generator)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    base = _dense_init(config, device=dev, generator=generator)
    blocks = base["blocks"]
    for name in _DENSE_MLP:
        blocks.pop(name, None)
    c = config
    std = 0.02
    res_std = std / math.sqrt(2 * c.n_layers)
    L, E = c.n_layers, c.n_experts

    def normal(shape, s):
        return torch.empty(shape, dtype=c.param_dtype, device=dev).normal_(0.0, s,
                                                                            generator=generator)

    blocks["router"] = normal((L, c.d_model, E), std)
    blocks["we_gate"] = normal((L, E, c.d_model, c.d_ff), std)
    blocks["we_up"] = normal((L, E, c.d_model, c.d_ff), std)
    blocks["we_down"] = normal((L, E, c.d_ff, c.d_model), res_std)
    return base


def logical_axes(config: MoEConfig) -> Params:
    axes = _dense_axes(config)
    blocks = axes["blocks"]
    for name in _DENSE_MLP:
        blocks.pop(name, None)
    blocks["router"] = ("layers", "embed", None)
    blocks["we_gate"] = ("layers", "expert", "embed", "mlp")
    blocks["we_up"] = ("layers", "expert", "embed", "mlp")
    blocks["we_down"] = ("layers", "expert", "mlp", "embed")
    return axes


# -------------------------------------------------------------------- routing


def _route(probs: torch.Tensor, top_k: int, capacity: int):
    """(gate weights (B,S,k), keep (B,S,k,E), slot one-hot (B,S,k,E,C)):
    each token's top-k experts, their renormalised weights, whether the
    choice fits its expert's capacity and its queue slot there, in (S*k)
    order (GShard)."""
    num_experts = probs.shape[-1]
    weights, idx = torch.topk(probs, top_k, dim=-1)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
    onehot = F.one_hot(idx, num_experts).to(probs.dtype)  # (B,S,k,E)
    b, s, k, e = onehot.shape
    # queue position of each (token, choice) within its expert, in (S*k) order
    flat = onehot.permute(0, 2, 1, 3).reshape(b, k * s, e)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    pos = pos_flat.reshape(b, k, s, e).permute(0, 2, 1, 3).to(torch.int64)
    keep = (pos < capacity).to(probs.dtype) * onehot
    pos_onehot = F.one_hot(pos.clamp(0, capacity - 1), capacity).to(probs.dtype)
    return weights, keep, pos_onehot


def topk_dispatch(probs: torch.Tensor, top_k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard dense dispatch. probs (B, S, E) -> dispatch (B,S,E,C) {0,1},
    combine (B,S,E,C) gate-weighted; tokens over capacity are dropped."""
    weights, keep, pos_onehot = _route(probs, top_k, capacity)
    dispatch = torch.einsum("bske,bskec->bsec", keep, pos_onehot)
    combine = torch.einsum("bsk,bske,bskec->bsec", weights, keep, pos_onehot)
    return dispatch, combine


def load_balancing_loss(probs: torch.Tensor, dispatch: torch.Tensor,
                        spmd: Any = None) -> torch.Tensor:
    """Switch aux loss: E * sum_e (token frac to e * mean router prob of
    e), both means over the global batch (over the data axes under
    `spmd`)."""
    num_experts = probs.shape[-1]
    b, s = probs.shape[:2]
    frac_sum = dispatch.sum(dim=-1).sum(dim=(0, 1))  # (E,)
    prob_sum = probs.sum(dim=(0, 1))
    count = torch.tensor(float(b * s), device=probs.device)
    if spmd is not None:
        frac_sum, prob_sum = spmd.data_reduce(frac_sum), spmd.data_reduce(prob_sum)
        count = spmd.data_sum(count)
    return num_experts * torch.sum((frac_sum / count) * (prob_sum / count))


def moe_mlp_sublayer(x: torch.Tensor, lp: Params, config: MoEConfig,
                     spmd: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE FFN + residual; returns (out, aux_loss). Under `spmd`
    the experts are this rank's (`lp`'s expert axis holds them) and their
    partial output is summed over ep."""
    c = config
    dt = c.dtype
    h = _norm(x, lp["ln2_scale"], lp.get("ln2_bias"), c.norm)
    b, s, _ = h.shape
    capacity = max(1, int(c.capacity_factor * c.top_k * s / c.n_experts))

    router_logits = torch.einsum("bsm,me->bse", h.float(), lp["router"].float())
    probs = torch.softmax(router_logits, dim=-1)
    weights, keep, pos_onehot = _route(probs, c.top_k, capacity)
    dispatch = torch.einsum("bske,bskec->bsec", keep, pos_onehot)
    aux = load_balancing_loss(probs, dispatch, spmd)

    first, last = (0, c.n_experts) if spmd is None else spmd.expert_range(c.n_experts)
    if spmd is not None:
        h = spmd.enter("mlp", spmd.enter("expert", h))
        weights = spmd.enter("expert", weights)
    keep, pos_onehot = keep[..., first:last], pos_onehot[..., first:last, :]
    dispatch = dispatch[..., first:last, :]
    combine = torch.einsum("bsk,bske,bskec->bsec", weights, keep, pos_onehot)
    # dispatch: (B,S,E,C) x (B,S,M) -> (E,B,C,M), this rank's experts
    expert_in = torch.einsum("bsec,bsm->ebcm", dispatch.to(dt), h)
    gate = torch.einsum("ebcm,emf->ebcf", expert_in, lp["we_gate"].to(dt))
    up = torch.einsum("ebcm,emf->ebcf", expert_in, lp["we_up"].to(dt))
    act = swiglu(gate, up)
    expert_out = torch.einsum("ebcf,efm->ebcm", act, lp["we_down"].to(dt))
    if spmd is not None:
        expert_out = spmd.leave("mlp", expert_out)
    out = torch.einsum("ebcm,bsec->bsm", expert_out, combine.to(dt))
    if spmd is not None:
        out = spmd.leave("expert", out)
    return x + out, aux


# -------------------------------------------------------------------- forward


def _moe_block(x, params, i, config, rope_tables, positions, spmd):
    lp = layer_params(params, i, spmd, config.dtype)
    x = attention_sublayer(x, lp, config, rope_tables, positions, spmd)
    return moe_mlp_sublayer(x, lp, config, spmd)


def forward(
    params: Params,
    tokens: torch.Tensor,
    config: MoEConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    spmd: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) -> (logits (B,S,V), total aux loss); under a split vocabulary,
    this rank's logit columns."""
    c = config
    dt = c.dtype
    s = tokens.shape[1]
    x = embed(params, tokens, c, spmd)
    if c.pos_emb == "learned":
        x = x + params["wpe"][:s].to(dt)[None]
        rope_tables = None
    else:
        rope_tables = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=x.device)
    gathered = spmd is not None and spmd.gathers_layers
    remat = (c.remat or gathered) and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(c.n_layers):
        if remat:
            x, layer_aux = checkpoint(_moe_block, x, params, i, c, rope_tables, positions, spmd,
                                      use_reentrant=False)
        else:
            x, layer_aux = _moe_block(x, params, i, c, rope_tables, positions, spmd)
        aux = aux + layer_aux
    lnf_bias = params.get("lnf_bias")
    x = _norm(x, params["lnf_scale"], lnf_bias, c.norm)
    if spmd is not None:
        x = spmd.enter("head", x)
    return x @ lm_head_weights(params, c, spmd), aux


def moe_loss(params: Params, tokens: torch.Tensor, config: MoEConfig, *,
             spmd: Any = None) -> Tuple[torch.Tensor, Any]:
    """Next-token CE + router aux: (loss, (ce, aux, num_tokens)).

    Under `spmd`, `tokens` are this rank's rows and the loss is the global
    batch's (the CE's token mean and the aux over every rank's rows). Its
    gradient here is this rank's share: summed over the data axes
    (`ModelSharding.sync_grads`) it is the global loss's gradient, as
    JAX's is."""
    logits, aux = forward(params, tokens[:, :-1], config, spmd=spmd)
    vocab = spmd.vocab_shard(logits.shape[-1]) if spmd is not None else None
    ce, ntok = cross_entropy_loss(logits, tokens[:, 1:], vocab=vocab)
    coeff = config.router_aux_coeff
    if spmd is None:
        return ce + coeff * aux, (ce, aux, ntok)
    total = spmd.data_sum(ntok.float())
    share = ce * (ntok.float() / total)
    global_ce = spmd.data_sum(share)
    # the value is the global loss; the gradient this rank's share of it
    # (the aux's gradient reaches each rank's rows through data_reduce)
    loss = share + coeff * aux
    loss = loss + (global_ce - share.detach())
    return loss, (global_ce, aux, total)
