"""Request plumbing shared by the serving engines.

Port of the parts of `ray_tpu/serve/llm/engine.py` the paged engine uses:
the request record, the per-request token stream, stop-sequence matching
and the engine-death path. The dense slot-grid `LLMEngine` is not ported
yet; tracing spans, request forensics, deadlines and tenancy are left out
(a request carries its caller's `request_id`, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import List, Optional


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_tokens: int
    temperature: float
    out: "queue.Queue"
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    # sampling params (vLLM SamplingParams parity)
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    stop_token_ids: tuple = ()
    # multi-token stop sequences: generation ends when the tail of the
    # emitted tokens equals any of these
    stop_sequences: tuple = ()
    stop_tail: list = dataclasses.field(default_factory=list)
    generated: int = 0  # tokens emitted so far
    request_id: Optional[str] = None  # the caller's end-to-end id
    cached_tokens: int = 0  # prompt tokens served by the prefix cache


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
    sequence is now its suffix."""
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
