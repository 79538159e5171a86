"""The serving side of a run: build the port's server on the benchmark's
weights, offer the cell's traffic to `LLMServer(...).engine.submit` and
time what comes back through each `ResponseStream`, on the host's clock
at the client.

- Open loop: a sender thread submits each request at its due time and
  notes how late it ran; one consumer thread per request iterates its
  stream and records when each token reached the client. After the
  window the run waits for every request sent in it (a late answer is
  late, not missing; one that never comes has failed).
- Backlog: `depth` requests are submitted at the window's start and each
  one that finishes is replaced at once, until the window closes; what is
  still running then is abandoned (its tokens after the close are not
  counted, and it is neither judged nor failed).

Set-up builds the engine with every pass captured (`precompile`), then
sends one warm-up request through a mixed tick and a decode block, so the
window's first requests pay no first-use cost.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from . import traffic as traffic_mod
from . import weights as weights_mod

DTYPES = weights_mod.DTYPES


@dataclasses.dataclass
class Record:
    """One request as the client saw it (host perf_counter seconds)."""

    index: int
    prompt: List[int]
    max_tokens: int
    due: Optional[float] = None      # absolute, open loop
    sent: float = 0.0
    first: Optional[float] = None
    last: Optional[float] = None
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    cached: int = 0
    error: Optional[str] = None
    done: bool = False
    abandoned: bool = False

    @property
    def ok(self) -> bool:
        return self.done and self.error is None and len(self.tokens) == self.max_tokens


def model_config(config: Dict[str, Any]):
    """The port's TransformerConfig for a configuration file's `model`."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    m = dict(config["model"])
    for key in ("dtype", "param_dtype"):
        m[key] = DTYPES[m[key]]
    m.pop("norm_eps", None)  # the port's norms carry their own epsilon
    return TransformerConfig(**m)


def engine_config(config: Dict[str, Any]):
    from ray_tpu_torch.serve.llm import PagedConfig, PagedEngineConfig

    e = config["engine"]
    return PagedEngineConfig(
        max_slots=e["max_slots"], decode_block_steps=e["decode_block_steps"],
        max_inflight_blocks=e["max_inflight_blocks"], precompile=e["precompile"],
        paged=PagedConfig(page_size=e["page_size"], num_pages=e["num_pages"],
                          max_pages_per_slot=e["max_pages_per_slot"],
                          chunk_pages=e["chunk_pages"], prefix_cache=e["prefix_cache"]))


class Serving:
    """The server under test and the client that drives it."""

    def __init__(self, config: Dict[str, Any], seed: int, device: torch.device):
        from ray_tpu_torch.serve.llm import LLMServer

        self.config = config
        self.device = device
        self.weights = weights_mod.make(config["model"], seed, device)
        self.server = LLMServer(model_config(config), params=self.weights,
                                engine_config=engine_config(config), device=device)
        self.engine = self.server.engine
        self.records: List[Record] = []
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._streams: Dict[int, Any] = {}
        self.late_s: List[float] = []

    def warm_up(self, prompts: List[List[int]] = ()) -> None:
        """One request through a mixed tick, its first token and a decode
        block, then wait for it: graphs replay, host paths run once. Then
        each of `prompts` once (one token each), which leaves their pages
        in the prefix cache."""
        chunk = self.config["engine"]["chunk_pages"] * self.config["engine"]["page_size"]
        prompt = [1 + (i % 1000) for i in range(chunk + 7)]
        self.engine.submit(prompt, self.config["engine"]["decode_block_steps"] + 3).result(
            timeout=600)
        for p in prompts:
            self.engine.submit(p, 1).result(timeout=600)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ client

    def _consume(self, rec: Record, stream: Any, on_done=None) -> None:
        try:
            for token in stream:
                now = time.perf_counter()
                if rec.first is None:
                    rec.first = now
                rec.times.append(now)
                rec.tokens.append(int(token))
            rec.last = rec.times[-1] if rec.times else None
        except BaseException as exc:  # noqa: BLE001 - a failed request is recorded, not raised
            rec.error = repr(exc)
        finally:
            rec.cached = int(stream.cached_tokens)
            rec.done = True
            if on_done is not None:
                on_done(rec)

    def _send(self, rec: Record, on_done=None) -> None:
        rec.sent = time.perf_counter()
        try:
            stream = self.engine.submit(rec.prompt, rec.max_tokens, 0.0)
        except Exception as exc:  # noqa: BLE001 - a refused request has failed
            rec.error = repr(exc)
            rec.done = True
            return
        self._streams[rec.index] = stream
        t = threading.Thread(target=self._consume, args=(rec, stream, on_done), daemon=True)
        t.start()
        self._threads.append(t)

    def open_loop(self, schedule: List[traffic_mod.Request], t0: float) -> threading.Thread:
        """Start sending `schedule` (due times relative to t0) from a sender
        thread; returns the thread."""
        sender = threading.Thread(target=self._send_all, args=(schedule, t0), daemon=True)
        sender.start()
        return sender

    def _send_all(self, schedule: List[traffic_mod.Request], t0: float) -> None:
        for req in schedule:
            rec = Record(req.index, req.prompt, req.max_tokens, due=t0 + req.due)
            self.records.append(rec)
            delay = rec.due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            self.late_s.append(max(0.0, time.perf_counter() - rec.due))
            self._send(rec)

    def wait_all(self, deadline: float) -> None:
        for t in list(self._threads):
            t.join(timeout=max(0.0, deadline - time.perf_counter()))

    def backlog(self, stream: "traffic_mod.Backlog", depth: int, t1: float) -> None:
        """Put `depth` requests in the system; each one that finishes before
        t1 is replaced at once (from its consumer's thread)."""
        def refill(_: Record) -> None:
            if time.perf_counter() < t1:
                self._next(stream, refill)

        for _ in range(depth):
            self._next(stream, refill)

    def _next(self, stream: "traffic_mod.Backlog", on_done) -> None:
        with self._lock:
            req = stream.next()
            rec = Record(req.index, req.prompt, req.max_tokens)
            self.records.append(rec)
        self._send(rec, on_done)

    # ---------------------------------------------------------- shutdown

    def close(self) -> None:
        """Stop the engine; streams still open are ended and marked
        abandoned. Frees the engine (pool, graphs) but keeps the weights."""
        self.engine.shutdown()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for rec in self.records:
            if not rec.done:
                rec.abandoned = True
                stream = self._streams.get(rec.index)
                if stream is not None:
                    stream._request.out.put(None)  # end the consumer's iteration
        for t in self._threads:
            t.join(timeout=10)
        self.server.engine = None
        self.engine = None
        self.server = None
        self._streams.clear()
