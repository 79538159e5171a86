"""Paged continuous-batching engine (port of
`ray_tpu/serve/llm/paged_engine.py`).

- The device holds one fixed PAGE POOL shared by all slots (paged.py); a
  slot's KV occupancy scales with its actual tokens.
- Prefill is CHUNKED and runs in the MIXED TICK: one pass ingests a chunk
  for every prefilling slot while every decodable lane advances one step
  in the same ragged-attention launch, so a long prompt delays running
  streams by one chunk, never by its full length.
- Decode-only ticks run a BLOCK of K fused decode+sample steps; sampled
  tokens stay on the device between the steps of a block.
- Backpressure is physical: admission, prefill growth and decode growth
  all wait on the page allocator; finished slots return their pages.

Each device pass runs eagerly, and its sampled tokens are read back to
the host when the pass ends (one device-to-host copy per tick), so
emission and retirement happen in the tick that produced the tokens.
Running passes as captured CUDA graphs and overlapping the read-back with
the next dispatch are later work; so are speculative decoding, the
prefix cache with copy-on-write, lane preemption, fair-queue tenancy,
deadlines, request tracing and tensor parallelism, which the JAX engine
has.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..._device import resolve_device
from ...models.transformer import TransformerConfig
from .engine import (
    ResponseStream,
    _Request,
    _fail_all_requests,
    _hit_stop_sequence,
    _normalize_stop_sequences,
)
from .paged import (
    PageAllocator,
    PagedConfig,
    init_paged_cache,
    paged_decode_step,
    ragged_mixed_step,
)
from .speculative import filtered_scores


@dataclasses.dataclass
class PagedEngineConfig:
    max_slots: int = 8
    eos_id: int = -1
    decode_block_steps: int = 16  # K: fused decode+sample steps per dispatch
    paged: PagedConfig = dataclasses.field(default_factory=PagedConfig)


# ------------------------------------------------------------------ sampling


def _categorical(scores: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(scores), by the Gumbel-max
    construction jax.random.categorical uses (the bits differ: the
    generator is torch's)."""
    u = torch.rand(scores.shape, generator=generator, device=scores.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)


def _sample_plain(logits, generator, temps):
    """temperature-only / greedy sampling — the common fast path."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    sampled = _categorical(scaled, generator)
    return torch.where(temps <= 0.0, greedy, sampled)


def _sample_filtered(logits, generator, temps, top_ks, top_ps):
    """Per-lane temperature + top-k + top-p (nucleus) sampling."""
    greedy = torch.argmax(logits, dim=-1)
    final = filtered_scores(logits, temps, top_ks, top_ps)
    sampled = _categorical(final, generator)
    return torch.where(temps <= 0.0, greedy, sampled)


def mixed_block_q(chunk_tokens: int) -> int:
    """Ragged q-block size for a given prefill chunk length: 8 whenever the
    chunk divides by it, else the largest power of two that does."""
    bq = 8
    while chunk_tokens % bq:
        bq //= 2
    return max(bq, 1)


def run_decode_block(
    params, cache, block_tables, tokens, positions, config: TransformerConfig,
    *, page_size: int, steps: int, sample: Callable[[torch.Tensor], torch.Tensor],
):
    """K fused decode+sample steps; tokens never leave the device inside
    the block. Returns ((K+1, B) tokens — row 0 is the INPUT token
    vector — and the pool, updated in place)."""
    rows = [tokens]
    for _ in range(steps):
        logits, cache = paged_decode_step(
            params, cache, block_tables, tokens, positions, config,
            page_size=page_size,
        )
        tokens = sample(logits)
        positions = positions + 1
        rows.append(tokens)
    return torch.stack(rows), cache


# -------------------------------------------------------------------- engine


@dataclasses.dataclass
class _PagedSlot:
    request: Optional[_Request] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    position: int = 0          # next KV write index
    prefill_offset: int = 0    # prompt tokens already ingested
    stalled: bool = False      # waiting on a page
    dispatch_remaining: int = 0
    done_dispatching: bool = False
    emit_remaining: int = 0
    finished_emit: bool = False

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        return (
            self.request is not None
            and self.prefill_offset < len(self.request.prompt)
        )

    @property
    def decodable(self) -> bool:
        return (
            self.request is not None
            and not self.prefilling
            and not self.done_dispatching
            and self.dispatch_remaining > 0
        )


def _check_params_device(params: Any, device: torch.device) -> None:
    leaves = list(params["blocks"].values()) + [
        v for k, v in params.items() if k != "blocks"
    ]
    for leaf in leaves:
        if leaf.device.type != device.type:
            raise ValueError(
                f"params live on {leaf.device} but the engine runs on {device}"
            )


class PagedLLMEngine:
    """Continuous batching over a paged KV pool with chunked prefill and
    K-step decode blocks, on one device."""

    def __init__(
        self,
        model_config: TransformerConfig,
        params: Any,
        engine_config: Optional[PagedEngineConfig] = None,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.model_config = model_config
        self.params = params
        self.config = engine_config or PagedEngineConfig()
        pc = self.config.paged
        if pc.max_pages_per_slot % pc.chunk_pages:
            raise ValueError(
                f"max_pages_per_slot ({pc.max_pages_per_slot}) must be a "
                f"multiple of chunk_pages ({pc.chunk_pages}): prefill grows "
                "page tables chunk-aligned"
            )
        if pc.chunk_pages > pc.num_pages - 1:
            raise ValueError(
                f"chunk_pages ({pc.chunk_pages}) exceeds the pool "
                f"({pc.num_pages - 1} allocatable pages)"
            )
        self.paged = pc
        self.cache = init_paged_cache(model_config, pc, self.device)
        self.allocator = PageAllocator(pc.num_pages)
        ms = self.config.max_slots
        self.slots = [_PagedSlot() for _ in range(ms)]
        self.block_tables = np.zeros((ms, pc.max_pages_per_slot), dtype=np.int32)
        # each slot's pending input token (its last sampled token)
        self._tokens = np.zeros((ms,), dtype=np.int64)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._rid = itertools.count()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._death_cause: Optional[BaseException] = None
        self._block_q = mixed_block_q(pc.chunk_tokens)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self.metrics: Dict[str, float] = {
            "generated_tokens": 0.0,
            "decode_steps": 0.0,
            "decode_blocks": 0.0,
            "prefill_chunks": 0.0,
            "ongoing": 0.0,
            "page_stalls": 0.0,
            "pages_in_use": 0.0,
            "prefill_tokens": 0.0,
            "decode_tokens": 0.0,
            "mixed_ticks": 0.0,
        }
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="paged-llm-engine"
        )
        self._thread.start()

    # ------------------------------------------------------------------- API

    def submit(
        self,
        prompt_tokens: List[int],
        max_tokens: int = 64,
        temperature: float = 0.0,
        *,
        top_k: int = 0,
        top_p: float = 1.0,
        stop_token_ids: Optional[List[int]] = None,
        stop_sequences: Optional[List[List[int]]] = None,
    ) -> ResponseStream:
        limit = self.paged.max_slot_tokens
        if len(prompt_tokens) + max_tokens > limit:
            raise ValueError(
                f"prompt({len(prompt_tokens)}) + max_tokens({max_tokens}) "
                f"exceeds per-slot page capacity {limit}"
            )
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        request = _Request(
            rid=next(self._rid),
            prompt=[int(t) for t in prompt_tokens],
            max_tokens=max_tokens,
            temperature=temperature,
            out=queue.Queue(),
            top_k=int(top_k),
            top_p=float(top_p),
            stop_token_ids=tuple(stop_token_ids or ()),
            stop_sequences=_normalize_stop_sequences(stop_sequences),
        )
        self._queue.put(request)
        # the death path records its cause BEFORE draining the queue, so a
        # submit that lands after the final drain fails here instead of
        # waiting on a loop that will never run
        if self._death_cause is not None:
            _fail_all_requests([], self._queue, self._death_cause)
            raise RuntimeError("LLM engine is dead") from self._death_cause
        self._wake.set()
        return ResponseStream(request)

    def generate(
        self, prompt_tokens: List[int], max_tokens: int = 64,
        temperature: float = 0.0, **sampling,
    ) -> List[int]:
        return self.submit(prompt_tokens, max_tokens, temperature, **sampling).result()

    def stats(self) -> Dict[str, float]:
        """The metrics dict plus the live free-page count."""
        out = dict(self.metrics)
        out["pages_free"] = float(self.allocator.available)
        return out

    def shutdown(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("paged engine loop did not stop")

    # -------------------------------------------------------------- sampling

    def _sample(self, logits, temps: np.ndarray, top_ks: np.ndarray,
                top_ps: np.ndarray) -> torch.Tensor:
        """Sample one token per row. The choice of sampler is made on the
        host from the request parameters, so an all-greedy batch is one
        argmax and a plain-temperature batch skips the vocabulary sort."""
        if (temps <= 0.0).all():
            return torch.argmax(logits, dim=-1)
        dev = logits.device
        t = torch.from_numpy(temps).to(dev)
        if (top_ks > 0).any() or (top_ps < 1.0).any():
            return _sample_filtered(
                logits, self._gen, t, torch.from_numpy(top_ks).to(dev),
                torch.from_numpy(top_ps).to(dev),
            )
        return _sample_plain(logits, self._gen, t)

    def _lane_params(self, lanes: List[Tuple[int, int]], n: int):
        """Per-row sampling parameters for (row, slot) pairs; other rows greedy."""
        temps = np.zeros((n,), dtype=np.float32)
        top_ks = np.zeros((n,), dtype=np.int64)
        top_ps = np.ones((n,), dtype=np.float32)
        for lane, idx in lanes:
            request = self.slots[idx].request
            temps[lane] = request.temperature
            top_ks[lane] = request.top_k
            top_ps[lane] = request.top_p
        return temps, top_ks, top_ps

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # ------------------------------------------------------------- admission

    def _grow(self, idx: int, slot: _PagedSlot, pages_needed: int) -> bool:
        """Grow a slot's page list to `pages_needed`; False (and the slot
        marked stalled) when the pool is short."""
        if pages_needed <= len(slot.pages):
            return True
        extra = self.allocator.alloc(pages_needed - len(slot.pages))
        if extra is None:
            if not slot.stalled:
                slot.stalled = True
                self.metrics["page_stalls"] += 1
            return False
        slot.pages.extend(extra)
        self.block_tables[idx, : len(slot.pages)] = slot.pages
        return True

    def _admit(self) -> None:
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for idx, slot in enumerate(self.slots):
            if not slot.free:
                continue
            if not self._pending:
                return
            request = self._pending.popleft()
            pages = self.allocator.alloc(self.paged.chunk_pages)
            if pages is None:
                # deferred admission keeps its place at the head of the queue
                self._pending.appendleft(request)
                self.metrics["page_stalls"] += 1
                return
            slot.request = request
            slot.pages = pages
            slot.position = 0
            slot.prefill_offset = 0
            slot.stalled = False
            slot.dispatch_remaining = 0
            slot.done_dispatching = False
            slot.emit_remaining = request.max_tokens
            slot.finished_emit = False
            self.block_tables[idx, :] = 0
            self.block_tables[idx, : len(pages)] = pages

    # ------------------------------------------------------------ mixed tick

    def _mixed_tick(self) -> bool:
        """THE mixed tick: one ragged-paged-attention pass ingests a chunk
        for EVERY prefilling slot AND advances every decodable lane one
        step. Prefill lanes pad to the next power of two; final chunks
        sample their first tokens. Decode-only ticks return False and the
        K-step decode block takes over."""
        ct = self.paged.chunk_tokens
        cp = self.paged.chunk_pages
        ps = self.paged.page_size
        maxp = self.paged.max_pages_per_slot
        ms = self.config.max_slots
        work = []  # (slot_idx, offset, first_page)
        for idx, slot in enumerate(self.slots):
            if not slot.prefilling:
                continue
            offset = slot.prefill_offset
            first_page = offset // ps
            if not self._grow(idx, slot, min(first_page + cp, maxp)):
                continue
            slot.stalled = False
            work.append((idx, offset, first_page))
        if not work:
            return False
        b = min(1 << (len(work) - 1).bit_length(), ms)
        tokens = np.zeros((b, ct), dtype=np.int64)
        page_rows = np.zeros((b + ms, maxp), dtype=np.int32)
        chunk_ids = np.zeros((b, cp), dtype=np.int64)  # inactive → scratch 0
        offsets = np.zeros((b,), dtype=np.int64)
        totals = np.zeros((b,), dtype=np.int64)  # 0 = inactive lane
        for lane, (idx, offset, first_page) in enumerate(work):
            slot = self.slots[idx]
            prompt = slot.request.prompt
            n_real = min(ct, len(prompt) - offset)
            self.metrics["prefill_tokens"] += float(n_real)
            tokens[lane, :n_real] = prompt[offset : offset + n_real]
            page_rows[lane] = self.block_tables[idx]
            window = slot.pages[first_page : first_page + cp]
            chunk_ids[lane, : len(window)] = window
            offsets[lane] = offset
            totals[lane] = offset + n_real
        # decode ride-along: every decodable lane advances one step
        dec_positions = np.zeros((ms,), dtype=np.int64)
        dec_active = np.zeros((ms,), dtype=np.int64)
        dec_lanes: List[int] = []
        cap = self.paged.max_slot_tokens
        for i, slot in enumerate(self.slots):
            if not slot.decodable:
                continue
            if slot.position + 1 > cap:
                slot.done_dispatching = True
                continue
            if not self._grow(i, slot, slot.position // ps + 1):
                continue
            slot.stalled = False
            page_rows[b + i] = self.block_tables[i]
            dec_positions[i] = slot.position
            dec_active[i] = 1
            dec_lanes.append(i)
        logits, dec_logits, self.cache = ragged_mixed_step(
            self.params,
            self.cache,
            self._to_device(page_rows),
            self._to_device(chunk_ids),
            self._to_device(tokens),
            self._to_device(offsets),
            self._to_device(totals),
            self._to_device(self._tokens.copy()),
            self._to_device(dec_positions),
            self._to_device(dec_active),
            self.model_config,
            page_size=ps,
            block_q=self._block_q,
        )
        self.metrics["mixed_ticks"] += 1
        finished = []  # (lane, slot_idx) whose prompt completed this tick
        for lane, (idx, _, _) in enumerate(work):
            slot = self.slots[idx]
            slot.prefill_offset = int(totals[lane])
            slot.position = int(totals[lane])
            self.metrics["prefill_chunks"] += 1
            if not slot.prefilling:
                finished.append((lane, idx))
        dec_sampled = pre_sampled = None
        if dec_lanes:
            dec_sampled = self._sample(
                dec_logits, *self._lane_params([(i, i) for i in dec_lanes], ms)
            )
        if finished:
            pre_sampled = self._sample(logits, *self._lane_params(finished, b))
        # one read-back for the tick's sampled tokens
        dec_host = dec_sampled.tolist() if dec_sampled is not None else None
        pre_host = pre_sampled.tolist() if pre_sampled is not None else None
        for i in dec_lanes:
            slot = self.slots[i]
            token = int(dec_host[i])
            self._tokens[i] = token
            slot.position += 1
            slot.dispatch_remaining -= 1
            if slot.dispatch_remaining <= 0:
                slot.done_dispatching = True
            self._emit(i, slot.request, token)
        if dec_lanes:
            self.metrics["decode_blocks"] += 1
            self.metrics["decode_steps"] += 1
        for lane, idx in finished:
            slot = self.slots[idx]
            token = int(pre_host[lane])
            self._tokens[idx] = token
            slot.dispatch_remaining = slot.request.max_tokens - 1
            if slot.dispatch_remaining <= 0:
                slot.done_dispatching = True
            self._emit(idx, slot.request, token, first=True)
        return True

    # ---------------------------------------------------------------- decode

    def _dispatch_decode_block(self) -> bool:
        """One K-step fused decode+sample block for every decodable lane."""
        K = self.config.decode_block_steps
        ps = self.paged.page_size
        cap = self.paged.max_slot_tokens
        ms = self.config.max_slots
        bt = np.zeros_like(self.block_tables)  # inactive lanes → scratch
        positions = np.zeros((ms,), dtype=np.int64)
        lanes: List[int] = []
        useful_steps: Dict[int, int] = {}
        for i, slot in enumerate(self.slots):
            if not slot.decodable:
                continue
            # only the USEFUL steps of a lane's final block need real pages;
            # overshoot steps write to unmapped table entries (the scratch
            # page) and their tokens are dropped at emission
            useful = min(K, slot.dispatch_remaining)
            if slot.position + useful > cap:
                slot.done_dispatching = True
                continue
            if not self._grow(i, slot, (slot.position + useful - 1) // ps + 1):
                continue
            slot.stalled = False
            bt[i] = self.block_tables[i]
            positions[i] = slot.position
            useful_steps[i] = useful
            lanes.append(i)
        if not lanes:
            return False
        temps, top_ks, top_ps = self._lane_params([(i, i) for i in lanes], ms)
        toks, self.cache = run_decode_block(
            self.params, self.cache, self._to_device(bt),
            self._to_device(self._tokens.copy()), self._to_device(positions),
            self.model_config, page_size=ps, steps=K,
            sample=lambda logits: self._sample(logits, temps, top_ks, top_ps),
        )
        host = toks.tolist()  # (K+1, B): row 0 is the input tokens
        for i in lanes:
            slot = self.slots[i]
            request = slot.request
            slot.position += useful_steps[i]
            slot.dispatch_remaining -= K
            if slot.dispatch_remaining <= 0:
                slot.done_dispatching = True
            self._tokens[i] = host[K][i]
            for k in range(1, K + 1):
                self._emit(i, request, int(host[k][i]))
        self.metrics["decode_blocks"] += 1
        self.metrics["decode_steps"] += K
        return True

    # -------------------------------------------------------------- emission

    def _emit(self, idx: int, request: _Request, token: int, first: bool = False) -> None:
        slot = self.slots[idx]
        if slot.request is not request or slot.finished_emit:
            return  # overshoot step of a finished stream
        if first and request.first_token_at is None:
            request.first_token_at = time.perf_counter()
        request.generated += 1
        request.out.put(token)
        slot.emit_remaining -= 1
        self.metrics["generated_tokens"] += 1
        if not first:  # first tokens are the prefill's output
            self.metrics["decode_tokens"] += 1.0
        if (
            token == self.config.eos_id
            or token in request.stop_token_ids
            or _hit_stop_sequence(request, token)
            or slot.emit_remaining <= 0
        ):
            slot.finished_emit = True

    def _maybe_retire(self, idx: int) -> None:
        slot = self.slots[idx]
        if slot.request is not None and (slot.finished_emit or slot.done_dispatching):
            self._finish(idx, slot)

    def _finish(self, idx: int, slot: _PagedSlot) -> None:
        if slot.request is not None:
            slot.request.out.put(None)
        self.allocator.free(slot.pages)
        slot.pages = []
        slot.request = None
        slot.stalled = False
        slot.dispatch_remaining = 0
        slot.finished_emit = False
        self.block_tables[idx, :] = 0

    # ------------------------------------------------------------------ loop

    def _all_stalled_deadlock(self) -> Optional[int]:
        """Every occupied slot waits on an empty pool: truncate the largest
        page-holder rather than deadlock."""
        occupied = [(i, s) for i, s in enumerate(self.slots) if not s.free]
        if not occupied:
            return None
        if all(s.stalled or s.prefilling for _, s in occupied) and (
            self.allocator.available == 0
        ):
            return max(occupied, key=lambda t: len(t[1].pages))[0]
        return None

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as exc:  # noqa: BLE001 - engine death boundary
            self._death_cause = exc
            for request in self._pending:
                self._queue.put(request)
            self._pending.clear()
            _fail_all_requests(self.slots, self._queue, exc)
            raise

    def _loop_inner(self) -> None:
        pc = self.paged
        while not self._stop.is_set():
            self._admit()
            progressed = self._mixed_tick()
            if not progressed:
                progressed = self._dispatch_decode_block()
            for i, slot in enumerate(self.slots):
                if slot.request is not None and not slot.prefilling:
                    self._maybe_retire(i)
            occupied = sum(1 for s in self.slots if not s.free)
            self.metrics["ongoing"] = float(
                occupied + self._queue.qsize() + len(self._pending)
            )
            self.metrics["pages_in_use"] = float(
                pc.num_pages - 1 - self.allocator.available
            )
            if occupied == 0:
                self._wake.wait(timeout=0.02)
                self._wake.clear()
                continue
            if not progressed:
                victim = self._all_stalled_deadlock()
                if victim is not None:
                    self._finish(victim, self.slots[victim])
                else:
                    time.sleep(0.001)
