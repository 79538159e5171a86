"""The training side of a run: the port's `LMTrainer` on the benchmark's
initial weights, fed packed batches made on the host from the seed.

Set-up builds one trainer, copies the benchmark's weights into its
float32 masters and drives it through its first steps with the window's
own call (`LMTrainer.train`) and feed, reading what the check compares:
each step's loss (from its reports), each leaf's norm of the first
step's gradient as the optimizer got it (Adam's first moment after one
step is (1 - b1) times that gradient), and after the first steps each
leaf's norm of the parameters' change. The same trainer then trains
through the window: `train` pulls batches from a feed that ends when the
window's time is up, and the card is synchronised before the window
closes, so every step counted has finished.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from . import traffic as traffic_mod
from . import weights as weights_mod
from .serve import model_config
from .trace import Trace


class Feed:
    """Batches for `LMTrainer.train`: each made on the host, pinned and
    copied to the card without a wait (the copy queues behind the steps
    already queued). Counts the batches handed out and the host seconds
    spent making and handing them (the trainer's input wait)."""

    def __init__(self, batches: traffic_mod.PackedBatches, device: torch.device):
        self.batches = batches
        self.device = device
        self.handed = 0
        self.wait_s = 0.0
        self.kept: List[np.ndarray] = []

    def take(self, n: int, keep: bool = False) -> Iterator[Dict[str, torch.Tensor]]:
        for _ in range(n):
            yield self._next(keep)

    def until(self, deadline: float, hook=None) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches until `deadline`; `hook(now)` runs before each one."""
        while True:
            now = time.perf_counter()
            if hook is not None:
                hook(now)
            if now >= deadline:
                return
            yield self._next(False)

    def _next(self, keep: bool) -> Dict[str, torch.Tensor]:
        t = time.perf_counter()
        rows = self.batches.next()
        if keep:
            self.kept.append(rows)
        tokens = torch.from_numpy(rows)
        if self.device.type == "cuda":
            tokens = tokens.pin_memory().to(self.device, non_blocking=True)
        self.handed += 1
        self.wait_s += time.perf_counter() - t
        return {"tokens": tokens}


def optimizer(config: Dict[str, Any]):
    """The port's optimizer with the configuration's numbers; raises where
    the port's AdamW cannot run them as stated."""
    from ray_tpu_torch.train.lm import default_optimizer

    o = config["train"]["optimizer"]
    opt = default_optimizer(o["learning_rate"], warmup_steps=o["warmup_steps"],
                            total_steps=o["total_steps"], weight_decay=o["weight_decay"],
                            b1=o["b1"], b2=o["b2"], grad_clip=o["grad_clip"])
    expected = (opt.eps, opt.schedule(0), opt.schedule(10**9))
    if expected != (o["eps"], o["init_lr"], o["end_lr"]) or \
            o["decay_steps"] != max(o["total_steps"], o["warmup_steps"] + 1):
        raise ValueError(f"the port's AdamW runs eps, init, end lr {expected}, not the "
                         "configuration's")
    return opt


class Training:
    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any], seed: int,
                 device: torch.device):
        from ray_tpu_torch.train import LMTrainer

        self.config = config
        self.seed = seed
        self.device = device
        m = config["model"]
        self.trainer = LMTrainer(model_config(config), optimizer=optimizer(config), device=device,
                                 total_steps=config["train"]["optimizer"]["total_steps"])
        tree = weights_mod.make(m, seed, device)
        with torch.no_grad():
            mine = weights_mod.flat_leaves(tree)
            for path, leaf in weights_mod.flat_leaves(self.trainer.state.params).items():
                leaf.copy_(mine[path])
        del tree, mine
        self.feed = Feed(traffic_mod.PackedBatches(traffic, seed, m["vocab_size"]), device)
        self.tokens_per_step = int(traffic["batch"]) * int(traffic["seq"])
        self.losses: List[float] = []
        self.grad_norm: Dict[str, float] = {}
        self.change_norm: Dict[str, float] = {}

    def first_steps(self, n: int) -> None:
        """Steps 1..n through `train` (reports every step, for the losses),
        reading the first gradient after step 1 and the change after n."""
        b1 = self.config["train"]["optimizer"]["b1"]
        report = lambda metrics: self.losses.append(float(metrics["loss"]))  # noqa: E731
        self.trainer.train(self.feed.take(1, keep=True), report_every=1, report_fn=report)
        with torch.no_grad():
            self.grad_norm = {p: float(mu.norm()) / (1 - b1) for p, mu in
                              weights_mod.flat_leaves(self.trainer.state.opt_state.mu).items()}
        if n > 1:
            self.trainer.train(self.feed.take(n - 1, keep=True), report_every=1,
                               report_fn=report)
        start = weights_mod.flat_leaves(weights_mod.make(self.config["model"], self.seed,
                                                         self.device))
        with torch.no_grad():
            self.change_norm = {p: float((leaf - start[p]).norm()) for p, leaf in
                                weights_mod.flat_leaves(self.trainer.state.params).items()}
        del start
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, trace_s: float = 0.0) -> Dict[str, Any]:
        """Train until `seconds` have passed; returns the window's steps,
        its length (to the card's synchronisation), the feed's wait and,
        with `trace_s`, the trace of its last `trace_s` seconds (opened
        between two steps and closed at the window's end, on the only
        thread that launches work)."""
        handed, wait = self.feed.handed, self.feed.wait_s
        t0 = time.perf_counter()
        state: Dict[str, Any] = {"trace": None}

        def hook(now: float) -> None:
            if trace_s and state["trace"] is None and now >= t0 + seconds - trace_s:
                state["trace"] = Trace().start()

        self.trainer.train(self.feed.until(t0 + seconds, hook), report_every=10**12)
        if state["trace"] is not None:
            state["trace"].stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "steps": self.feed.handed - handed,
                "input_wait_s": self.feed.wait_s - wait, "trace": state["trace"]}

    def close(self) -> None:
        self.trainer = None
