"""Tune trainables of the port, importable by module.

`gpt2_pbt` trains a transformer preset (GPT-2 124M on the card in
`chip_smoke.py`'s `libraries` phase, gpt2-tiny on the CPU in
`tests/test_torch_tune.py`) through `create_train_state` /
`make_train_step` under `ray_tpu_torch.tune`, for Population Based
Training over its learning rate. Only the standard library is imported at
load; torch and the port are imported inside the trainable. It stops at a
step boundary once its session reads preempted, as the Tuner asks of a
trial it exploits or stops.
"""

import collections
import threading

_LOCK = threading.Lock()
_STEPS: "collections.Counter[str]" = collections.Counter()  # trial dir -> steps taken


def steps_taken() -> dict:
    """Train steps taken so far by every incarnation, by trial directory."""
    with _LOCK:
        return dict(_STEPS)


def reset_steps() -> None:
    with _LOCK:
        _STEPS.clear()


def fingerprint(state) -> list:
    """Two int64 sums over the bits of every tensor of a TrainState
    (params, then Adam's moments): equal states give equal fingerprints,
    and a flipped bit changes them."""
    import torch

    from ray_tpu_torch.train import tree_leaves

    out = []
    for t in (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
              + tree_leaves(state.opt_state.nu)):
        bits = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        weights = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
        out.append((int(bits.sum()), int((bits * weights).sum())))
    return out


def gpt2_pbt(config: dict) -> None:
    """Train `config["model"]` on one fixed batch (made from `seed`) for
    `steps` steps at `config["lr"]` (AdamW, constant but for the cosine tail
    to 0.1x over `steps`), reporting the loss every step and checkpointing
    the whole TrainState through the tune session every `ckpt_every` steps.
    A restored incarnation continues from its checkpoint's step and
    reports the fingerprint of the state it restored; a checkpoint's report
    carries the fingerprint of the state it saved. Runs on
    `config.get("device", "cuda")`; `pause_s` (default 0) sleeps after each
    step, so that on the CPU a tiny model's steps interleave with the
    Tuner's polls as GPT-2's do on the card."""
    import time

    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.train import (
        create_train_state,
        default_optimizer,
        get_context,
        is_preempted,
        make_train_step,
    )

    device = resolve_device(config.get("device", "cuda"))
    trial_dir = get_context().trial_dir
    ckpt = tune.get_checkpoint()
    model = get_config(config["model"])
    steps, every = int(config["steps"]), int(config["ckpt_every"])
    opt = default_optimizer(config["lr"], warmup_steps=0, total_steps=steps)
    restored = None
    if ckpt is not None:
        state = ckpt["state"]
        start = ckpt["step"]
        restored = {"restored_step": start, "restored_fingerprint": fingerprint(state)}
    else:
        state = create_train_state(model, opt, int(config["seed"]), device=device)
        start = 0
    gen = torch.Generator(device=device).manual_seed(int(config["seed"]) + 1)
    tokens = torch.randint(0, model.vocab_size, (int(config["batch"]), int(config["seq"]) + 1),
                           generator=gen, device=device)
    step_fn = make_train_step(model, opt, device=device)
    for step in range(start, steps):
        if is_preempted():
            return
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        loss = float(metrics["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
        with _LOCK:
            _STEPS[trial_dir] += 1
        report = {"loss": loss, "step": step + 1, "lr": config["lr"], "step_ms": step_ms}
        if restored is not None:
            report.update(restored)
            restored = None
        if (step + 1) % every == 0:
            report["fingerprint"] = fingerprint(state)
            tune.report(report, checkpoint={"step": step + 1, "state": state})
        else:
            tune.report(report)
        time.sleep(float(config.get("pause_s", 0.0)))
    if restored is not None:  # restored at the last step: nothing left to train
        tune.report({"step": start, **restored})
