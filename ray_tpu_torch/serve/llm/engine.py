"""The dense continuous-batching engine, and the request plumbing both
engines share.

Port of `ray_tpu/serve/llm/engine.py`. `LLMEngine` owns a fixed SLOT GRID
— a decode batch of `max_slots` lanes over one dense KV cache (L, B, Hkv,
S, Dh). Requests stream in and out of slots between steps; the decode
step never changes shape, so on the card it is one CUDA graph (captured
when the engine is built, `graphs.DevicePass`), with the temperature
sampler inside it and the engine's generator registered. Prefill pads a
prompt to a power-of-two bucket and runs eagerly, one flash-attention
launch per layer at B 1, writing the prompt's K/V straight into the
slot's cache lane. Scheduling (admit → prefill → joint decode → retire)
happens on the host between device steps, and, as in the JAX engine, the
loop thread reads each step's sampled tokens back before the next: this
engine is not pipelined (the paged engine is).

Both engines share the admission gate (`_check_admission`: the admit-queue
bound, tenant token-bucket quotas, already-expired deadlines), the TTFT
decomposition (`_charge_wait`, `_ttft_buckets`, `_observe_tenant_ttft`)
and the deadline path (`_timeout_request`). Tracing spans, request
forensics marks and the Prometheus-style gauges and histograms of the JAX
package are not ported; per-tenant TTFT windows and counts live in
`serve/tenancy.py`.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..._device import resolve_device
from ...core.exceptions import BackPressureError, RequestTimeoutError
from ...models.transformer import TransformerConfig, decode_step, init_cache, prefill
from ...ops import rope_frequencies
from .. import tenancy
from .graphs import DevicePass, to_device
from .speculative import categorical


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8  # concurrent sequences = decode batch width
    max_seq: Optional[int] = None  # KV capacity per slot (default model max)
    eos_id: int = -1  # -1: never stop on a token
    prefill_bucket_min: int = 16
    # admission bound on the submit queue: overflow raises a typed
    # BackPressureError instead of queueing unboundedly. 0 = auto
    # (8 x max_slots); negative disables the bound.
    max_queued_requests: int = 0


@dataclasses.dataclass
class _Slot:
    request: Optional["_Request"] = None
    position: int = 0
    remaining: int = 0
    last_token: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_tokens: int
    temperature: float
    out: "queue.Queue"
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    # sampling params (vLLM SamplingParams parity; the paged engine honors all)
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    stop_token_ids: tuple = ()
    # multi-token stop sequences: generation ends when the tail of the
    # emitted tokens equals any of these
    stop_sequences: tuple = ()
    stop_tail: list = dataclasses.field(default_factory=list)
    generated: int = 0  # tokens emitted so far
    # end-to-end deadline (epoch seconds): expired requests fail fast at
    # admit and are evicted mid-generation
    deadline_ts: Optional[float] = None
    # multi-tenant admission: tenant keys the fair-queue lane and quota
    # bucket; priority (higher = more important) orders the queue's tiers
    # and gates lane preemption
    tenant: str = "default"
    priority: int = 0
    # tokens emitted since (re-)admission — a preempted lane folds these
    # into its prompt so the parked request resumes token-exact
    gen_tokens: list = dataclasses.field(default_factory=list)
    # True while parked by lane preemption (waiting in the fair queue with
    # its generated prefix folded into the prompt)
    parked: bool = False
    request_id: Optional[str] = None  # the caller's end-to-end id
    # TTFT decomposition: queue_wait / preempt_wait are charged at each
    # (re-)admission from enqueued_at, so at first token prefill_compute =
    # TTFT - queue_wait - preempt_wait by construction
    enqueued_at: Optional[float] = None
    queue_wait_s: float = 0.0
    preempt_wait_s: float = 0.0
    cached_tokens: int = 0  # prompt tokens served by the prefix cache
    # latch: the paged admit loop retries a page-stalled admission every
    # tick; one stall episode counts once per request
    stall_marked: bool = False


# ------------------------------------------------- admission and deadlines


def _queue_bound(config) -> int:
    """Resolve the engine's admit-queue bound: explicit, auto
    (8 x max_slots when 0), or unlimited (-1)."""
    bound = getattr(config, "max_queued_requests", 0)
    if bound == 0:
        return 8 * config.max_slots
    return bound


def _check_admission(engine, deadline_ts, tenant: str = "default") -> None:
    """Shared submit-time gate for both engines: bound the queue (typed
    BackPressureError on overflow), charge the tenant's token bucket
    (typed shed carrying the bucket's refill time as retry_after_s), and
    fail already-expired deadlines fast instead of queueing work nobody
    will wait for."""
    bound = _queue_bound(engine.config)
    backlog = engine._queue.qsize() + len(getattr(engine, "_fair", ()))
    if bound >= 0 and backlog >= bound:
        engine.metrics["shed"] += 1
        tenancy.count_shed(tenant)
        raise BackPressureError(f"engine admit queue is full ({bound} waiting requests)")
    retry_after_s = tenancy.quota_check(tenant)
    if retry_after_s is not None:
        engine.metrics["shed"] += 1
        tenancy.count_shed(tenant, retry_after_s)
        raise BackPressureError(
            f"tenant {tenant!r} is over its token-bucket quota",
            retry_after_s=retry_after_s,
        )
    if deadline_ts is not None and time.time() >= deadline_ts:
        engine.metrics["timeouts"] += 1
        raise RequestTimeoutError("request deadline expired before submit")
    tenancy.count_request(tenant)


def _charge_wait(request: _Request) -> float:
    """Charge the time since the request was (re-)enqueued into the right
    TTFT-decomposition bucket: preempt_wait for a parked lane being
    re-admitted, queue_wait otherwise. Called at each successful
    admission, BEFORE the admit path clears `parked`."""
    now = time.perf_counter()
    wait = max(0.0, now - (request.enqueued_at if request.enqueued_at is not None
                           else request.submitted_at))
    if request.parked:
        request.preempt_wait_s += wait
    else:
        request.queue_wait_s += wait
    request.enqueued_at = None
    return wait


def _ttft_buckets(request: _Request) -> Dict[str, float]:
    """TTFT decomposition at the first-token point. The three summed
    buckets are exact by construction (prefill_compute is the remainder);
    cache_saved is an estimate of the prefill time the prefix cache
    skipped, NOT part of the sum."""
    ttft = max(0.0, request.first_token_at - request.submitted_at)
    queue_wait = min(request.queue_wait_s, ttft)
    preempt_wait = min(request.preempt_wait_s, max(0.0, ttft - queue_wait))
    prefill_compute = max(0.0, ttft - queue_wait - preempt_wait)
    buckets = {
        "ttft_s": ttft,
        "queue_wait_s": queue_wait,
        "preempt_wait_s": preempt_wait,
        "prefill_compute_s": prefill_compute,
        "cache_saved_s": 0.0,
    }
    prefilled = len(request.prompt) - request.cached_tokens
    if request.cached_tokens > 0 and prefilled > 0:
        buckets["cache_saved_s"] = prefill_compute * request.cached_tokens / prefilled
        buckets["cached_tokens"] = request.cached_tokens
    return buckets


def _observe_tenant_ttft(request: _Request) -> Dict[str, float]:
    """First-token hook shared by both engines: report the request's TTFT
    and its decomposition into the tenancy windows, and return the
    buckets. Only ever called for requests that produced a token."""
    if request.first_token_at is None:
        return {}
    buckets = _ttft_buckets(request)
    tenancy.observe_ttft(request.tenant, buckets["ttft_s"])
    tenancy.observe_ttft_breakdown(request.tenant, buckets)
    return buckets


def _timeout_request(request: _Request) -> None:
    """Fail a request on deadline expiry: the stream raises a typed
    RequestTimeoutError."""
    request.out.put(RequestTimeoutError(
        f"request {request.rid} cancelled: deadline exceeded after "
        f"{request.generated} generated token(s)"
    ))


def _normalize_stop_sequences(stop_sequences) -> tuple:
    seqs = tuple(
        tuple(int(t) for t in seq) for seq in (stop_sequences or ()) if seq
    )
    if any(len(s) == 0 for s in seqs):
        raise ValueError("stop sequences must be non-empty token lists")
    return seqs


def _hit_stop_sequence(request: _Request, token: int) -> bool:
    """Per-token stop check over the decoded tail: append the emitted
    token to the request's rolling tail and report whether any stop
    sequence is now its suffix. Shared by the dense and paged engines."""
    seqs = request.stop_sequences
    if not seqs:
        return False
    tail = request.stop_tail
    tail.append(int(token))
    longest = max(len(s) for s in seqs)
    if len(tail) > longest:
        del tail[: len(tail) - longest]
    return any(
        len(tail) >= len(s) and tuple(tail[-len(s):]) == s for s in seqs
    )


class ResponseStream:
    """Per-request token stream: iterate for streaming, .result() to drain."""

    def __init__(self, request: _Request):
        self._request = request

    def __iter__(self):
        while True:
            token = self._request.out.get()
            if token is None:
                return
            if isinstance(token, BaseException):
                raise token
            yield token

    def result(self, timeout: Optional[float] = None) -> List[int]:
        tokens: List[int] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            token = self._request.out.get(timeout=remaining)
            if token is None:
                return tokens
            if isinstance(token, BaseException):
                raise token
            tokens.append(token)

    @property
    def ttft_s(self) -> Optional[float]:
        if self._request.first_token_at is None:
            return None
        return self._request.first_token_at - self._request.submitted_at

    @property
    def request_id(self) -> Optional[str]:
        """The caller's end-to-end request id (None when none was given)."""
        return self._request.request_id

    @property
    def cached_tokens(self) -> int:
        """Prompt tokens this request took from the prefix cache at
        admission (0 before admission)."""
        return self._request.cached_tokens



def _sample_plain(logits, generator, temps):
    """temperature-only / greedy sampling — the common fast path."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    sampled = categorical(scaled, generator)
    return torch.where(temps <= 0.0, greedy, sampled)


def _check_params_device(params: Any, device: torch.device) -> None:
    leaves = list(params["blocks"].values()) + [
        v for k, v in params.items() if k != "blocks"
    ]
    for leaf in leaves:
        if leaf.device.type != device.type:
            raise ValueError(
                f"params live on {leaf.device} but the engine runs on {device}"
            )


class LLMEngine:
    """The dense slot-grid engine on one device."""

    def __init__(
        self,
        model_config: TransformerConfig,
        params: Any,
        engine_config: Optional[EngineConfig] = None,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.model_config = model_config
        self.params = params
        self.config = engine_config or EngineConfig()
        self.max_seq = self.config.max_seq or model_config.max_seq
        b = self.config.max_slots
        mc = model_config

        self.cache = init_cache(mc, b, self.max_seq, device=self.device)
        self.slots = [_Slot() for _ in range(b)]
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._rid = itertools.count()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._death_cause: Optional[BaseException] = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        rope = (None if mc.pos_emb == "learned" else
                rope_frequencies(mc.head_dim, mc.max_seq, mc.rope_theta, device=self.device))

        def decode(tokens, positions, temps):
            logits, _ = decode_step(self.params, self.cache, tokens, positions, mc,
                                    rope_tables=rope)
            return _sample_plain(logits, self._gen, temps)

        i64 = torch.int64
        self._decode = DevicePass(
            "decode", decode,
            {"tokens": ((b,), i64), "positions": ((b,), i64), "temps": ((b,), torch.float32)},
            self.device, self._gen)
        self.capture_s = 0.0
        if self.device.type == "cuda":
            # one graph, captured before any request: its warm-up run writes
            # row 0 of every (still empty) cache lane
            self._decode.capture()
            torch.cuda.synchronize(self.device)
            self.capture_s = self._decode.capture_s
        self.metrics: Dict[str, float] = {
            "generated_tokens": 0.0,
            "decode_steps": 0.0,
            "prefills": 0.0,
            "ongoing": 0.0,
            "shed": 0.0,
            "timeouts": 0.0,
            "batch_fill": 0.0,
            "prefill_tokens": 0.0,
            "decode_tokens": 0.0,
        }
        self._thread = threading.Thread(target=self._loop, daemon=True, name="llm-engine")
        self._thread.start()

    # ------------------------------------------------------------------ API

    def submit(
        self,
        prompt_tokens: List[int],
        max_tokens: int = 64,
        temperature: float = 0.0,
        *,
        stop_token_ids: Optional[List[int]] = None,
        stop_sequences: Optional[List[List[int]]] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        deadline_ts: Optional[float] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        request_id: Optional[str] = None,
    ) -> ResponseStream:
        if len(prompt_tokens) + max_tokens > self.max_seq:
            raise ValueError(
                f"prompt({len(prompt_tokens)}) + max_tokens({max_tokens}) exceeds "
                f"engine max_seq {self.max_seq}"
            )
        if top_k or top_p != 1.0:
            raise ValueError(
                "top_k/top_p sampling lives in PagedLLMEngine (the dense "
                "engine samples temperature-only); use PagedEngineConfig"
            )
        tenant = tenant or "default"
        _check_admission(self, deadline_ts, tenant)
        request = _Request(
            rid=next(self._rid),
            prompt=[int(t) for t in prompt_tokens],
            max_tokens=max_tokens,
            temperature=temperature,
            out=queue.Queue(),
            stop_token_ids=tuple(stop_token_ids or ()),
            stop_sequences=_normalize_stop_sequences(stop_sequences),
            deadline_ts=deadline_ts,
            tenant=tenant,
            priority=int(priority or 0),
            request_id=request_id,
        )
        request.enqueued_at = time.perf_counter()
        self._queue.put(request)
        _reject_if_dead(self)
        self._wake.set()
        return ResponseStream(request)

    def generate(
        self, prompt_tokens: List[int], max_tokens: int = 64, temperature: float = 0.0
    ) -> List[int]:
        return self.submit(prompt_tokens, max_tokens, temperature).result()

    def stats(self) -> Dict[str, float]:
        """The metrics dict, and the decode pass's runs (`passes.decode`:
        graph replays on the card, eager runs on the CPU) and the kernel
        launches its replays made (`launches.<kernel>`: none, its attention
        is two batched products). Prefill's flash launches go through the
        wrapper: `prefills` x layers."""
        out = dict(self.metrics)
        out[f"passes.{self._decode.name}"] = float(self._decode.runs)
        for kernel, n in self._decode.launches().items():
            out[f"launches.{kernel}"] = float(n)
        return out

    def shutdown(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("engine thread did not stop")

    def snapshot(self) -> Dict[str, Any]:
        """Live engine introspection: the lane table plus queue depth.
        Lock-free point-in-time read (a lane row may be a step stale)."""
        lanes: List[Dict[str, Any]] = []
        for idx, slot in enumerate(self.slots):
            request = slot.request
            lane: Dict[str, Any] = {"lane": idx, "free": request is None}
            if request is not None:
                lane.update(
                    rid=request.rid,
                    request_id=request.request_id,
                    tenant=request.tenant,
                    priority=request.priority,
                    position=slot.position,
                    remaining=slot.remaining,
                    generated=request.generated,
                )
            lanes.append(lane)
        return {"kind": "dense", "lanes": lanes, "queue_depth": self._queue.qsize()}

    # ------------------------------------------------------------ scheduling

    def _bucket(self, n: int) -> int:
        b = self.config.prefill_bucket_min
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def _admit(self) -> None:
        for slot_idx, slot in enumerate(self.slots):
            if not slot.free:
                continue
            while True:
                try:
                    request = self._queue.get_nowait()
                except queue.Empty:
                    return
                if request.deadline_ts is not None and time.time() >= request.deadline_ts:
                    # expired while queued: fail fast, never prefill
                    self.metrics["timeouts"] += 1
                    _timeout_request(request)
                    request.out.put(None)
                    continue
                break
            self._do_prefill(slot_idx, slot, request)

    def _do_prefill(self, slot_idx: int, slot: _Slot, request: _Request) -> None:
        """Prefill at the prompt's bucket (B 1: one flash launch per layer),
        K/V written straight into the slot's cache lane, then the first
        token sampled and read back."""
        _charge_wait(request)
        n = len(request.prompt)
        bucket = self._bucket(n)
        padded = np.zeros((1, bucket), dtype=np.int64)
        padded[0, :n] = request.prompt
        lane = {k: v[:, slot_idx:slot_idx + 1] for k, v in self.cache.items()}
        with torch.no_grad():
            last_logits, _ = prefill(
                self.params, to_device(padded, self.device),
                torch.tensor([n], device=self.device), lane, self.model_config)
            temps = to_device(np.array([request.temperature], dtype=np.float32), self.device)
            first = int(_sample_plain(last_logits, self._gen, temps)[0])
        request.first_token_at = time.perf_counter()
        _observe_tenant_ttft(request)
        self.metrics["prefill_tokens"] += float(n)
        request.generated += 1
        request.out.put(first)
        slot.request = request
        slot.position = n  # next write slot = first generated token
        slot.remaining = request.max_tokens - 1
        slot.last_token = first
        self.metrics["prefills"] += 1
        self.metrics["generated_tokens"] += 1
        if (
            slot.remaining <= 0
            or first == self.config.eos_id
            or first in request.stop_token_ids
            or _hit_stop_sequence(request, first)
        ):
            self._finish(slot)

    def _finish(self, slot: _Slot) -> None:
        if slot.request is not None:
            slot.request.out.put(None)
        slot.request = None
        slot.remaining = 0

    def _deadline_sweep(self) -> None:
        """Cancel slots whose request outlived its deadline — the lane
        frees for queued work instead of generating into the void."""
        now = time.time()
        for slot in self.slots:
            request = slot.request
            if request is None or request.deadline_ts is None:
                continue
            if now >= request.deadline_ts:
                self.metrics["timeouts"] += 1
                _timeout_request(request)
                self._finish(slot)

    def _decode_round(self) -> None:
        """One decode step over every slot (the graph on the card), its
        sampled tokens read back on this thread."""
        n = len(self.slots)
        tokens = np.zeros(n, dtype=np.int64)
        positions = np.zeros(n, dtype=np.int64)
        temps = np.zeros(n, dtype=np.float32)
        active = []
        for i, slot in enumerate(self.slots):
            if not slot.free:
                tokens[i] = slot.last_token
                positions[i] = slot.position
                temps[i] = slot.request.temperature
                active.append(i)
        with torch.no_grad():
            sampled = self._decode(tokens=tokens, positions=positions, temps=temps).tolist()
        self.metrics["decode_steps"] += 1
        self.metrics["decode_tokens"] += float(len(active))
        for i in active:
            slot = self.slots[i]
            token = int(sampled[i])
            slot.request.generated += 1
            slot.request.out.put(token)
            slot.last_token = token
            slot.position += 1
            slot.remaining -= 1
            self.metrics["generated_tokens"] += 1
            if (
                token == self.config.eos_id
                or token in slot.request.stop_token_ids
                or _hit_stop_sequence(slot.request, token)
                or slot.remaining <= 0
                or slot.position >= self.max_seq - 1
            ):
                self._finish(slot)

    def _loop(self) -> None:
        # The loop thread is the engine: if it dies, every pending stream
        # hangs forever. Fail them all with the cause instead.
        try:
            while not self._stop.is_set():
                self._admit()
                self._deadline_sweep()
                n_active = sum(1 for s in self.slots if not s.free)
                self.metrics["ongoing"] = float(n_active) + self._queue.qsize()
                self.metrics["batch_fill"] = n_active / max(len(self.slots), 1)
                if n_active == 0:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                self._decode_round()
        except BaseException as exc:  # noqa: BLE001 - engine death boundary
            self._death_cause = exc
            _fail_all_requests(self.slots, self._queue, exc)
            raise


def _fail_all_requests(slots, request_queue, exc: BaseException) -> None:
    """Engine-death path: surface `exc` on every active and queued stream."""
    for slot in slots:
        if slot.request is not None:
            slot.request.out.put(exc)
            slot.request = None
    while True:
        try:
            request = request_queue.get_nowait()
        except queue.Empty:
            return
        request.out.put(exc)


def _reject_if_dead(engine) -> None:
    """Close the submit-vs-death race: the death path sets _death_cause
    BEFORE draining the queue, so a submit that enqueued after the final
    drain observes _death_cause here and fails its own request instead of
    waiting on a loop that will never run."""
    cause = engine._death_cause
    if cause is not None:
        _fail_all_requests([], engine._queue, cause)
        raise RuntimeError("LLM engine is dead") from cause
