"""Faults planted underneath the timed path, each one a cell can have, to
show that `correct` catches them (`tests/test_bench_faults.py` on the CPU,
`readings.py --fault` on the card): a served token altered where the
engine emits it; a training step that returns its state unchanged; a step
that leaves half of its batch out and takes the mean over the rest. (One
card: there is no exchange between chips to leave out.) Each takes the
run's `Serving` or `Training` before its first request or step."""

from __future__ import annotations

from typing import Any


def token_altered(serving: Any) -> None:
    emit = serving.engine._emit
    vocab = serving.config["model"]["vocab_size"]

    def altered(idx, request, token, first=False):
        if request.generated == 2:  # the third token of every request
            token = (token + 1) % vocab
        return emit(idx, request, token, first)

    serving.engine._emit = altered


def state_unchanged(training: Any) -> None:
    from ray_tpu_torch.train.lm import global_norm, loss_and_grads

    trainer = training.trainer

    def step(state, batch):
        loss, ntok, grads = loss_and_grads(trainer.config, state.params, batch["tokens"])
        return state, {"loss": loss.float(), "grad_norm": global_norm(grads),
                       "num_tokens": ntok.float()}

    trainer.step_fn = step


def half_batch(training: Any) -> None:
    step = training.trainer.step_fn

    def half(state, batch):
        tokens = batch["tokens"]
        return step(state, {"tokens": tokens[: tokens.shape[0] // 2]})

    training.trainer.step_fn = half


FAULTS = {"token_altered": token_altered, "state_unchanged": state_unchanged,
          "half_batch": half_batch}
