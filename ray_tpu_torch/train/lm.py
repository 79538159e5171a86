"""LM training compute core: train state, optimizer, train and eval steps.

Port of `ray_tpu/train/lm.py` for one device: `default_optimizer` →
`create_train_state` → `make_train_step` → `make_eval_step`, with JAX's
names and signatures less the mesh. An explicit `device` (default "cuda",
raising without a CUDA device; "cpu" runs the plain paths) takes the
mesh's place. On the card the step runs the model in its compute dtype
over f32 master weights, and attention's gradient comes from the flash
backward kernels (`ops.flash_attention`).

What differs from JAX, and why:
- The step runs eagerly, not as one jitted program. Parameters and Adam
  moments are updated in place under `torch.no_grad()`, the counterpart of
  JAX's donated state buffers: `step(state, batch)` returns the same
  `TrainState` object, advanced.
- The optimizer is plain functions on tensor lists (`torch._foreach_*`)
  with optax's arithmetic: an `init` / `update` pair like an optax
  `GradientTransformation`, except that `update` applies the update to the
  parameters itself (optax returns updates for `apply_updates`).
- Step counts live on the host as Python ints (JAX keeps them on the
  device); the learning rate and bias corrections are host scalars, so the
  step reads nothing back from the device.
- `TrainState` has no `rng`: no JAX step reads its key (the model has no
  dropout), so the port drops it.

Not ported (ROADMAP queue A): the explicit data-parallel step
(`_make_explicit_dp_step`, the int8 all-reduce with error feedback,
`dp_shard_update`, `clip_by_global_norm_sharded`), `infer_state_specs`
and meshes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..models.transformer import (
    TransformerConfig,
    forward,
    forward_hidden,
    init_params,
    lm_head_weights,
)
from ..ops.losses import auto_loss_chunk, cross_entropy_loss, fused_linear_cross_entropy

Params = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a nested parameter dict, in insertion order."""
    out: List[torch.Tensor] = []
    for value in tree.values():
        if isinstance(value, dict):
            out.extend(tree_leaves(value))
        else:
            out.append(value)
    return out


def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Params) -> Params:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ----------------------------------------------------------------- optimizer


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine down to end_value at
    decay_steps (which counts the warmup), held there after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        span = decay_steps - warmup_steps
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass
class AdamWState:
    """Adam moments (trees like the params) and the number of updates
    applied so far (optax's `count`, here a host int)."""

    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm → AdamW with a learning-rate schedule, as the
    optax chain of `ray_tpu.train.lm.default_optimizer`.

    `init(params)` returns the state; `update(grads, state, params)`
    clips `grads` in place, updates the moments and the parameters in
    place and returns the state."""

    schedule: Callable[[int], float]
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float

    def init(self, params: Params) -> AdamWState:
        return AdamWState(count=0, mu=_tree_map(torch.zeros_like, params),
                          nu=_tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamWState, params: Params) -> AdamWState:
        p = tree_leaves(params)
        g = list(grads)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        # optax.clip_by_global_norm: (t / norm) * max_norm only when
        # norm >= max_norm (no epsilon, unlike torch's clip_grad_norm_)
        norm = global_norm(g)
        clip = norm >= self.grad_clip
        torch._foreach_div_(g, torch.where(clip, norm, torch.ones_like(norm)))
        torch._foreach_mul_(g, torch.where(clip, torch.full_like(norm, self.grad_clip),
                                           torch.ones_like(norm)))
        # optax.scale_by_adam: moments, bias correction at count + 1, eps
        # outside the square root
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count_inc = state.count + 1
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count_inc)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count_inc)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        # optax.add_decayed_weights on every leaf (no mask), then
        # scale_by_learning_rate at the schedule's value for this count
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.schedule(state.count))
        torch._foreach_add_(p, upd)
        state.count = count_inc
        return state


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm), f32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def default_optimizer(
    learning_rate: float = 3e-4,
    *,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> Optimizer:
    """AdamW + warmup-cosine schedule + global-norm clip (the GPT/Llama
    recipe), with optax's numbers: the schedule starts at 0 (the first
    update moves nothing), peaks at `learning_rate` after `warmup_steps`
    and ends at 0.1 * learning_rate at max(total_steps, warmup_steps + 1);
    Adam eps 1e-8."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=learning_rate,
        warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=learning_rate * 0.1,
    )
    return Optimizer(schedule=schedule, b1=b1, b2=b2, eps=1e-8,
                     weight_decay=weight_decay, grad_clip=grad_clip)


# --------------------------------------------------------------- train state


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # leaf tensors with requires_grad, f32 masters
    opt_state: AdamWState


def create_train_state(
    config: TransformerConfig,
    optimizer: Optimizer,
    seed: int = 0,
    *,
    params: Optional[Params] = None,
    device: Union[str, torch.device] = "cuda",
) -> TrainState:
    """A fresh TrainState on `device`: params from `init_params(config,
    seed)`, or copies of `params` (e.g. JAX weights carried with
    `params_from_numpy(..., dtype=torch.float32)`), and zero moments."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(config, seed, device=dev)
    params = _tree_map(lambda t: t.detach().to(dev).clone().requires_grad_(True), params)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


# ---------------------------------------------------------------- the steps


def loss_and_grads(
    config: TransformerConfig,
    params: Params,
    tokens: torch.Tensor,
    *,
    z_loss_coeff: float = 0.0,
    grad_accum: int = 1,
    loss_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(loss, num_tokens, grads) for tokens (B, S+1): the forward and
    backward of one train step. Microbatch gradients are summed, then
    scaled by 1/grad_accum, as JAX's scan does. grads follow
    `tree_leaves(params)`.

    loss_chunk > 0 takes the fused chunked head + loss; None picks it with
    `auto_loss_chunk` from the device's memory; 0 forces the dense loss."""
    leaves = tree_leaves(params)
    dev = tokens.device

    def loss_fn(tok):
        targets = tok[:, 1:]
        chunk = loss_chunk
        if chunk is None:
            chunk = auto_loss_chunk(tok.shape[0], tok.shape[1] - 1, config.vocab_size, device=dev)
        if chunk:
            hidden = forward_hidden(params, tok[:, :-1], config)
            return fused_linear_cross_entropy(
                hidden, lm_head_weights(params, config), targets,
                chunk=chunk, z_loss_coeff=z_loss_coeff,
            )
        logits = forward(params, tok[:, :-1], config)
        return cross_entropy_loss(logits, targets, z_loss_coeff=z_loss_coeff)

    if grad_accum == 1:
        loss, ntok = loss_fn(tokens)
        return loss.detach(), ntok, list(torch.autograd.grad(loss, leaves))
    if tokens.shape[0] % grad_accum:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by grad_accum {grad_accum}")
    grads: Optional[List[torch.Tensor]] = None
    total_loss = torch.zeros((), dtype=torch.float32, device=dev)
    total_ntok = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in tokens.view(grad_accum, tokens.shape[0] // grad_accum, *tokens.shape[1:]):
        loss, ntok = loss_fn(mb)
        mb_grads = torch.autograd.grad(loss, leaves)
        if grads is None:
            grads = list(mb_grads)
        else:
            torch._foreach_add_(grads, mb_grads)
        total_loss = total_loss + loss.detach()
        total_ntok = total_ntok + ntok
    scale = 1.0 / grad_accum
    torch._foreach_mul_(grads, scale)
    return total_loss * scale, total_ntok, grads


def make_train_step(
    config: TransformerConfig,
    optimizer: Optimizer,
    *,
    z_loss_coeff: float = 0.0,
    grad_accum: int = 1,
    loss_chunk: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Metrics]]:
    """One training step. batch = {"tokens": (B, S+1) int}. The state is
    updated in place (the counterpart of JAX's donation) and returned;
    metrics = {"loss", "grad_norm" (before the clip), "num_tokens"} as f32
    device tensors, read back by nothing inside the step.

    The two phases carry `torch.profiler` labels
    "steplog.fwd_bwd_compute" and "steplog.optimizer_update", as the JAX
    step's named scopes do."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, Metrics]:
        tokens = batch["tokens"].to(dev)
        with record_function("steplog.fwd_bwd_compute"):
            loss, ntok, grads = loss_and_grads(
                config, state.params, tokens, z_loss_coeff=z_loss_coeff,
                grad_accum=grad_accum, loss_chunk=loss_chunk,
            )
        with record_function("steplog.optimizer_update"):
            gnorm = global_norm(grads)
            state.opt_state = optimizer.update(grads, state.opt_state, state.params)
        state.step += 1
        metrics = {
            "loss": loss.float(),
            "grad_norm": gnorm,
            "num_tokens": ntok.float(),
        }
        return state, metrics

    return step


def make_eval_step(
    config: TransformerConfig, device: Union[str, torch.device] = "cuda"
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Metrics]:
    """Eval loss on batch = {"tokens": (B, S+1)}: {"eval_loss", "num_tokens"}."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Dict[str, torch.Tensor]) -> Metrics:
        tokens = batch["tokens"].to(dev)
        logits = forward(state.params, tokens[:, :-1], config)
        loss, ntok = cross_entropy_loss(logits, tokens[:, 1:])
        return {"eval_loss": loss.float(), "num_tokens": ntok}

    return eval_fn
