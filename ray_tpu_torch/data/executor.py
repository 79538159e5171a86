"""Streaming-executor substrate: byte-budgeted windows, locality, metrics.

Port of `ray_tpu/data/executor.py` for one process (reference parity:
python/ray/data/_internal/execution — the StreamingExecutor's
resource-budgeted backpressure and the locality-aware output splitting of
StreamSplitDataIterator):

- the in-flight window per stage is measured in BYTES, not just block
  count: when the object store's host bytes run past a fraction of its
  capacity the submitter backs off, bounded, then proceeds and rides the
  spill path instead of running out of memory;
- map tasks carry a `locality_hint` (core/scheduler.py TaskSpec) so they
  schedule onto the logical node that ran the task producing their input
  block;
- the consumer side pulls blocks ahead of need with a bounded
  prefetcher thread, so `api.get` overlaps the consumer's compute.

Everything here is orchestration: block bytes stay in the object store
and pass between tasks by reference. In a cluster a map task may run on a
node agent: a large block then stays in that agent's store (the object
store's REMOTE tier) and is pulled where a reader gets it.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from .. import api
from ..util.events import emit
from ..util.metrics import get_or_create_counter, get_or_create_gauge
from .block import Block, block_nbytes

# ------------------------------------------------------------------- metrics


def _metrics() -> Dict[str, Any]:
    """Data-plane series (idempotent: runtime re-init safe)."""
    return {
        "blocks_produced": get_or_create_counter(
            "raytpu_data_blocks_produced",
            "blocks produced by streaming dataset stages"),
        "bytes_produced": get_or_create_counter(
            "raytpu_data_bytes_produced",
            "bytes produced by streaming dataset stages"),
        "blocks_consumed": get_or_create_counter(
            "raytpu_data_blocks_consumed",
            "blocks pulled by dataset consumers"),
        "bytes_consumed": get_or_create_counter(
            "raytpu_data_bytes_consumed",
            "bytes pulled by dataset consumers"),
        "locality_hit_rate": get_or_create_gauge(
            "raytpu_data_locality_hit_rate",
            "fraction of hinted map tasks that ran on the block-holding node"),
        "inflight_bytes": get_or_create_gauge(
            "raytpu_data_inflight_bytes",
            "estimated bytes in the executor's in-flight window"),
        "backpressure_stall": get_or_create_counter(
            "raytpu_data_backpressure_stall_seconds",
            "seconds the submitter stalled on byte budget / store pressure"),
        "spilled_bytes": get_or_create_gauge(
            "raytpu_data_spilled_bytes",
            "object-store bytes spilled during the last streaming execution"),
    }


# ---------------------------------------------------------------- run stats


class StreamStats:
    """Counters for ONE streaming execution (a Dataset consumption).

    Thread-safe: the split pump, prefetcher threads, and k consumers all
    feed the same instance. `snapshot()` resolves locality hits lazily
    from the runtime's task-event log and folds in the object store's
    spill/reconstruction deltas since `__init__`.
    """

    def __init__(self, byte_budget: Optional[int] = None):
        self._lock = threading.Lock()
        self.byte_budget = byte_budget
        self.blocks_produced = 0        # guarded-by: _lock
        self.bytes_produced = 0         # guarded-by: _lock
        self.blocks_consumed = 0        # guarded-by: _lock
        self.bytes_consumed = 0         # guarded-by: _lock
        self.backpressure_stall_s = 0.0  # guarded-by: _lock
        self.max_inflight_bytes = 0     # guarded-by: _lock
        # (task_id_hex, hinted_node_hex) per hinted map task; resolved
        # against the task-event log at snapshot time
        self._locality: List[Tuple[str, str]] = []  # guarded-by: _lock
        self._stalled_once = False      # guarded-by: _lock
        store = self._store()
        self._spill0 = store.stats.get("spilled_bytes", 0) if store else 0
        self._spills0 = store.stats.get("spills", 0) if store else 0
        self._reexec0 = store.stats.get("reconstructions", 0) if store else 0
        self._finalized = False         # guarded-by: _lock

    @staticmethod
    def _store():
        # peek only: a stats object must never auto-initialize a runtime
        # as a side effect (api._runtime() would)
        from ..core import runtime as _rt

        if not _rt.is_initialized():
            return None
        return api._runtime().object_store

    # -- producer side --

    def note_produced(self, nbytes: int) -> None:
        m = _metrics()
        with self._lock:
            self.blocks_produced += 1
            self.bytes_produced += nbytes
        m["blocks_produced"].inc(1)
        m["bytes_produced"].inc(nbytes)

    def note_inflight(self, nbytes: int) -> None:
        with self._lock:
            self.max_inflight_bytes = max(self.max_inflight_bytes, nbytes)
        _metrics()["inflight_bytes"].set(nbytes)

    def note_stall(self, seconds: float, reason: str) -> None:
        first = False
        with self._lock:
            self.backpressure_stall_s += seconds
            if not self._stalled_once:
                self._stalled_once = first = True
        _metrics()["backpressure_stall"].inc(seconds)
        if first:
            emit("WARNING", "data",
                 f"ingest backpressure: {reason}",
                 kind="data.backpressure", reason=reason)

    def note_locality(self, task_id_hex: str, hint_hex: str) -> None:
        with self._lock:
            self._locality.append((task_id_hex, hint_hex))

    # -- consumer side --

    def note_consumed(self, nbytes: int) -> None:
        m = _metrics()
        with self._lock:
            self.blocks_consumed += 1
            self.bytes_consumed += nbytes
        m["blocks_consumed"].inc(1)
        m["bytes_consumed"].inc(nbytes)

    # -- resolution --

    def snapshot(self) -> Dict[str, Any]:
        """Resolve and return this execution's numbers (callable many
        times; spill/reexec events fire on the first call that sees a
        nonzero delta)."""
        store = self._store()
        spilled = reexec = spills = 0
        if store is not None:
            spilled = store.stats.get("spilled_bytes", 0) - self._spill0
            spills = store.stats.get("spills", 0) - self._spills0
            reexec = store.stats.get("reconstructions", 0) - self._reexec0
        hits, total = self._resolve_locality()
        rate = (hits / total) if total else 1.0
        m = _metrics()
        m["locality_hit_rate"].set(rate)
        m["spilled_bytes"].set(max(spilled, 0))
        with self._lock:
            first_final = not self._finalized
            self._finalized = True
            out = {
                "blocks_produced": self.blocks_produced,
                "bytes_produced": self.bytes_produced,
                "blocks_consumed": self.blocks_consumed,
                "bytes_consumed": self.bytes_consumed,
                "backpressure_stall_s": round(self.backpressure_stall_s, 4),
                "max_inflight_bytes": self.max_inflight_bytes,
                "byte_budget": self.byte_budget,
                "locality_hits": hits,
                "locality_total": total,
                "locality_hit_rate": round(rate, 4),
                "spill_count": max(spills, 0),
                "spilled_bytes": max(spilled, 0),
                "reexecuted_blocks": max(reexec, 0),
            }
        if first_final and spilled > 0:
            emit("INFO", "data",
                 f"ingest rode the spill path: {spilled} bytes in "
                 f"{spills} spills", kind="data.spill", bytes=spilled)
        if first_final and reexec > 0:
            emit("WARNING", "data",
                 f"{reexec} lost block(s) re-executed via lineage",
                 kind="data.reexec", blocks=reexec)
        return out

    def _resolve_locality(self) -> Tuple[int, int]:
        with self._lock:
            pairs = list(self._locality)
        if not pairs:
            return 0, 0
        from ..core import runtime as _rt

        if not _rt.is_initialized():
            return 0, len(pairs)
        ran_on = {ev["task_id"]: ev["node"] for ev in api._runtime().task_events()}
        hits = total = 0
        for task_hex, hint_hex in pairs:
            node = ran_on.get(task_hex)
            if node is None:
                continue  # still running: not a miss, just unresolved
            total += 1
            if node == hint_hex:
                hits += 1
        return hits, total


# ----------------------------------------------------------------- locality


def node_holding(ref) -> Optional[str]:
    """node_hex holding a block ref's bytes, or None: the logical node
    that executed the producing task (ObjectID ⊕ lineage: ids.py keeps
    the producer recoverable). A `put` block has no producing task."""
    return api._runtime().node_of_task(ref.object_id.task_id().hex())


def _known_nbytes(ref) -> Optional[int]:
    """Actual byte size of a ref's value if the store knows it yet."""
    entry = api._runtime().object_store.entry(ref.object_id)
    if entry is not None and entry.nbytes:
        return int(entry.nbytes)
    return None


# ------------------------------------------------------- budgeted submission


def budgeted_submit(
    items: Iterator[Any],
    submit: Callable[[Any], Any],
    *,
    stats: StreamStats,
    count_window: int,
    byte_budget: Optional[int] = None,
    pressure_fraction: float = 0.9,
    max_stall_s: float = 2.0,
    est_bytes: Optional[int] = None,
) -> Iterator[Any]:
    """Submit with a bounded in-flight window; yield refs in order.

    The window closes on whichever limit trips first: `count_window`
    refs in flight, or `byte_budget` estimated in-flight bytes. A
    not-yet-sealed output counts as `est_bytes` (the source's declared
    per-block size) when given, else as the largest size the store has
    sealed so far — so until the first block seals, an undeclared
    stage's window is count-limited only, and with heterogeneous block
    sizes the byte window is exact only once blocks at the large end
    have sealed (the budget can transiently overshoot; the spill path
    absorbs it). The first submission is always admitted, so a budget
    smaller than one block degrades to serial execution rather than
    deadlock.

    Store pressure: when host bytes exceed `pressure_fraction` of
    capacity, the submitter sleeps in small slices (accounted as
    backpressure-stall seconds) up to `max_stall_s`, then proceeds
    anyway — the object store's LRU spill path absorbs the overshoot,
    which is exactly the OOM-vs-spill trade this budget exists to make.
    """
    pending: deque = deque()
    # running size estimate for unsealed outputs: the source's declared
    # block size when known, raised to the max sealed size observed
    est = int(est_bytes or 0)

    def inflight() -> int:
        """Estimated bytes held by the pending window. Sealed outputs
        count their actual size (and raise the estimate); unsealed ones
        count the estimate."""
        nonlocal est
        total = 0
        for ref in pending:
            known = _known_nbytes(ref)
            if known is not None:
                est = max(est, known)
                total += known
            else:
                total += est
        return total

    def pressure_headroom() -> Optional[int]:
        store = StreamStats._store()
        if store is None:
            return None
        usage = store.usage()
        cap = usage.get("capacity_bytes") or 0
        if cap <= 0:
            return None
        return int(cap * pressure_fraction) - usage.get("host_bytes", 0)

    def pop_oldest():
        ref = pending.popleft()
        known = _known_nbytes(ref)
        stats.note_produced(known if known is not None else est)
        return ref

    for item in items:
        # window full by count OR the next submission would overshoot
        # the byte budget → yield oldest first (the yield IS the pull
        # that drains the window; downstream pace drives submission)
        while pending and (
            len(pending) >= count_window
            or (byte_budget is not None and inflight() + est > byte_budget)
        ):
            yield pop_oldest()
        # store-pressure backoff: bounded stall, then proceed and ride
        # the spill path (never livelock behind a full store)
        stalled = 0.0
        while stalled < max_stall_s:
            headroom = pressure_headroom()
            if headroom is None or headroom > 0:
                break
            time.sleep(0.05)
            stalled += 0.05
            stats.note_stall(0.05, "object store over pressure threshold")
        pending.append(submit(item))
        stats.note_inflight(inflight())
    while pending:
        yield pop_oldest()
    stats.note_inflight(0)


def locality_map_stream(
    stream: Iterator[Any],
    map_remote,
    *,
    stats: StreamStats,
    ctx,
    locality: bool = True,
) -> Iterator[Any]:
    """Map a ref stream through `map_remote` with byte-budgeted windows
    and locality-hinted submission (the map task runs where its input
    block was produced; the scheduler treats the hint as a soft
    preference, so a saturated node never strands the stage)."""
    from ..core.ids import NodeID

    def submit(ref):
        hint_hex = node_holding(ref) if locality else None
        if hint_hex is not None:
            out = map_remote.options(
                locality_hint=NodeID(hint_hex)).remote(ref)
            stats.note_locality(out.object_id.task_id().hex(), hint_hex)
            return out
        return map_remote.remote(ref)

    return budgeted_submit(
        stream, submit,
        stats=stats,
        count_window=ctx.prefetch_blocks,
        byte_budget=ctx.target_inflight_bytes,
        pressure_fraction=ctx.store_pressure_fraction,
        max_stall_s=ctx.backpressure_max_stall_s,
    )


# -------------------------------------------------------------- prefetching


class BlockPrefetcher:
    """Consumer-side prefetch: a background thread pulls upcoming block
    refs and materializes them ahead of need, so `api.get` latency (a
    task still running, spill restore, lineage re-execution) overlaps
    the consumer's compute. The bounded queue IS the prefetch window —
    at most `window` blocks sit materialized waiting for the consumer.
    """

    def __init__(self, ref_iter: Iterator[Any], window: int,
                 stats: Optional[StreamStats] = None):
        self._refs = ref_iter
        self._stats = stats
        self._q: "queue.Queue" = queue.Queue(maxsize=max(window, 1))
        self._closed = False  # guarded-by: _lock
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._pump, daemon=True, name="data-prefetch")
        self._thread.start()

    def _pump(self) -> None:
        try:
            for ref in self._refs:
                with self._lock:
                    if self._closed:
                        return
                block = api.get(ref)
                self._q.put(("block", block))
            self._q.put(("end", None))
        except BaseException as e:  # propagate to the consumer
            self._q.put(("error", e))

    def close(self) -> None:
        with self._lock:
            self._closed = True
        # unblock a pump parked on a full queue
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        close = getattr(self._refs, "close", None)
        if close is not None:
            try:
                close()
            except ValueError:
                pass  # "generator already executing": the pump is inside it and will see _closed

    def __iter__(self) -> Iterator[Block]:
        while True:
            kind, payload = self._q.get()
            if kind == "end":
                return
            if kind == "error":
                raise payload
            if self._stats is not None:
                self._stats.note_consumed(block_nbytes(payload))
            yield payload
