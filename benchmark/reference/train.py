"""The plain reference of the training step: next-token cross entropy
through `reference.transformer`, its gradients by autograd, a global-norm
clip and AdamW with a linear-warmup cosine schedule, all in float32 with
TF32 off, in plain PyTorch. Written from the published definitions
(optax's `clip_by_global_norm`, `adamw` and `warmup_cosine_decay_schedule`,
whose numbers the configuration file states), not from the program.

`run_steps` follows the first steps of a run from the benchmark's own
initial weights and batches and returns what the check compares: each
step's loss, each leaf's norm of the first step's clipped gradient, and
each leaf's norm of the parameters' change over the steps. The batch's
rows go through one at a time (their gradients summed), so the step fits
beside nothing else on the card.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from .transformer import flat, no_tf32, sequence_loss, unflat


def schedule(opt: Dict[str, Any], count: int) -> float:
    """Linear warmup from `init_lr` to `learning_rate` over `warmup_steps`,
    then a cosine to `end_lr` at `decay_steps`, held after."""
    peak, init, end = opt["learning_rate"], opt["init_lr"], opt["end_lr"]
    warm, decay = opt["warmup_steps"], opt["decay_steps"]
    if count < warm:
        return init + (peak - init) * count / warm
    t = min(count - warm, decay - warm)
    return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * t / (decay - warm)))


def run_steps(tree: Dict[str, Any], m: Dict[str, Any], opt: Dict[str, Any],
              batches: List[torch.Tensor], precision: str = "f32") -> Dict[str, Any]:
    """len(batches) AdamW steps from `tree` (float32 leaves, updated in
    place); batches are (B, S + 1) token tensors on the tree's device.
    Returns {"loss": [per step], "grad_norm": {leaf: first step's clipped
    gradient norm}, "change_norm": {leaf: norm of the total change}}."""
    leaves = flat(tree)
    names = list(leaves)
    start = {n: leaves[n].detach().clone() for n in names}
    params = {n: leaves[n].detach().requires_grad_(True) for n in names}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    with no_tf32():
        for step, batch in enumerate(batches):
            grads = {n: torch.zeros_like(p) for n, p in params.items()}
            model = unflat(params)
            total = 0.0
            for row in batch:
                loss = sequence_loss(model, m, row, precision) / batch.shape[0]
                for n, g in zip(names, torch.autograd.grad(loss, [params[n] for n in names])):
                    grads[n] += g
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
                if norm >= opt["grad_clip"]:
                    for g in grads.values():
                        g.mul_(opt["grad_clip"] / norm)
                if step == 0:
                    first_grad = {n: float(g.norm()) for n, g in grads.items()}
                lr = schedule(opt, step)
                t = step + 1
                for n, p in params.items():
                    mu[n].mul_(b1).add_(grads[n], alpha=1 - b1)
                    nu[n].mul_(b2).addcmul_(grads[n], grads[n], value=1 - b2)
                    upd = (mu[n] / (1 - b1 ** t)) / ((nu[n] / (1 - b2 ** t)).sqrt() + eps)
                    p.sub_(lr * (upd + wd * p))
            del grads
    with torch.no_grad():
        change = {n: float((params[n] - start[n]).norm()) for n in names}
    return {"loss": losses, "grad_norm": first_grad, "change_norm": change}
