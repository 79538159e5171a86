"""What decides `correct`: the program's outputs on the timed path,
compared with the plain reference (`benchmark/reference/`) once the
window has closed and the program's state is freed.

Serving: a sample, drawn from the seed, of the requests the window
finished, with the longest among them, until it holds `sample_tokens`
served tokens and `sample_requests` requests; the reference runs each
prompt with its served tokens once, and the number compared is the widest
gap by which a served (greedy) token's logit lies below the reference's
best at its position (`max_logit_gap`). The control reads, at the same positions, the gap of
the token that the fp8 control puts first.

Training: the first `first_steps` steps, which set-up ran through the
window's own call. Compared: each step's loss (`loss_gap`, relative);
each leaf's norm of the first gradient as the optimizer got it
(`grad_gap`); each leaf's norm of the change after the steps
(`change_gap`). A leaf's gap is |program - reference| over the larger of
the reference's norm of that leaf and of the median leaf; the number is
the worst leaf. Leaves whose reference gradient is under a thousandth of
the median leaf's (a key bias under softmax) move by round-off alone and
are left out of the change.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from . import traffic as traffic_mod


def sample_requests(records: Sequence[Any], seed: int, sample_tokens: int,
                    sample_requests: int = 1) -> List[Any]:
    """The longest finished request, then others in a seeded order until
    the sample holds `sample_tokens` served tokens and `sample_requests`
    requests. Where the window served prompts from the prefix cache, one
    such request is in it."""
    done = [r for r in records if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.index))
    rest = [r for r in done if r is not longest]
    order = traffic_mod.rng(seed, 7).permutation(len(rest))
    sample = [longest]
    if longest.cached == 0:
        cached = [r for r in rest if r.cached > 0]
        if cached:
            sample.append(cached[traffic_mod.rng(seed, 8).integers(len(cached))])
    for i in order:
        if (sum(len(r.tokens) for r in sample) >= sample_tokens
                and len(sample) >= sample_requests):
            break
        if rest[i] not in sample:
            sample.append(rest[i])
    return sample


def serve_numbers(weights: Dict[str, Any], model: Dict[str, Any], sample: Sequence[Any],
                  control: bool = False) -> Dict[str, float]:
    from ..reference.transformer import greedy_gaps

    gaps = [greedy_gaps(weights, model, r.prompt, r.tokens) for r in sample]
    out = {"max_logit_gap": max(g["max"] for g in gaps),
           "served_tokens_compared": float(sum(g["n"] for g in gaps)),
           "requests_compared": float(len(sample))}
    if control:
        ctl = [greedy_gaps(weights, model, r.prompt, r.tokens, control=True) for r in sample]
        out["control_max_logit_gap"] = max(g["max"] for g in ctl)
    return out


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Sequence[str]) -> float:
    """The worst leaf's |program - reference| over max(reference's norm of
    the leaf, the median leaf's)."""
    med = statistics.median(reference[k] for k in keep)
    return max(abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in keep)


def train_numbers(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, float]:
    grads = reference["grad_norm"]
    med = statistics.median(grads.values())
    moving = [k for k, g in grads.items() if g >= 1e-3 * med]
    losses = np.array(program["loss"]), np.array(reference["loss"])
    return {
        "loss_gap": float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1]))),
        "grad_gap": leaf_gap(program["grad_norm"], grads, list(grads)),
        "change_gap": leaf_gap(program["change_norm"], reference["change_norm"], moving),
        "leaves_left_out": float(len(grads) - len(moving)),
    }


def train_reference(config: Dict[str, Any], seed: int, batches: Sequence[np.ndarray],
                    device: torch.device, precision: str = "f32") -> Dict[str, Any]:
    from ..reference.train import run_steps
    from . import weights as weights_mod

    tree = weights_mod.make(config["model"], seed, device)
    tree = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
            for k, v in tree.items()}
    toks = [torch.from_numpy(b).to(device) for b in batches]
    return run_steps(tree, config["model"], config["train"]["optimizer"], toks, precision)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers.get(k, float("inf")) <= v for k, v in limits.items())
