"""Dataset: lazy plan → streaming execution over the task runtime.

Port of `ray_tpu/data/dataset.py` for one process (reference parity:
python/ray/data — logical plan, StreamingExecutor with backpressure, the
Dataset API: streaming_split, iter_batches, materialize):

- blocks are columnar numpy (block.py);
- the executor is pull-based: a bounded in-flight window of block tasks
  per stage, measured in blocks and bytes (executor.py), IS the
  backpressure; stages run as thread tasks and thread actors of the
  port's runtime, and blocks pass between them as object refs;
- `streaming_split` feeds k consumers (a gang's ranks) strict
  round-robin from one execution;
- `iter_torch_batches` on a CUDA device overlaps each batch's copy to the
  card with the consumer's step through a device-prefetch window
  (`_torch_batch_stream`, the counterpart of JAX's `iter_jax_batches` /
  `_jax_batch_stream`); on `device="cpu"` the same window hands over
  CPU tensors, the columns and dtypes of JAX's `iter_torch_batches`.

On a CUDA device each batch is pinned and copied with `non_blocking=True`
on a side stream, which records an event; when the batch is handed over,
the consumer's stream waits on that event (the host does not) and every
device tensor is marked as used on the consumer's stream
(`record_stream`), so the allocator does not hand its memory back to the
side stream while the consumer's kernels may still read it. The side
stream is created by the thread that builds the iterator; the consumer's
stream is read on the thread that takes each batch, so a gang rank's
actor thread orders its own kernels after the copy. The pinned source is
held with the batch until the batch is handed over; after that PyTorch's
pinned-memory allocator keeps the block until the copy's event has
passed. On the CPU the window wraps a batch without a copy.

`executor="process"` runs a map stage's tasks on pooled worker processes
(`core/worker_pool.py`), and `ActorPoolStrategy(n, executor="process")`
hosts each udf actor in a worker process of its own: GIL-free, for
CPU-bound udfs (tokenisation, cleaning, decoding). Blocks go to a worker
by value, or as read-only views of the object store's arena under
`cfg.native_store`; the udf (and a filter's or map's row function) must
be importable in the worker (`worker_pool.check_importable`: the
standard pickle, by reference), which `map_batches` checks when it is
called.
"""

from __future__ import annotations

import builtins
import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, ClassVar, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import api
from .._device import resolve_device
from .block import (
    Block,
    batches_from_blocks,
    block_concat,
    block_from_items,
    block_num_rows,
    block_slice,
    block_take,
    block_to_items,
)
from .datasource import (
    BinaryFilesSource,
    CsvSource,
    Datasource,
    ImageDirSource,
    ItemsSource,
    JsonlSource,
    NpyFileSource,
    NumpySource,
    ParquetSource,
    RangeSource,
    TextSource,
    TFRecordSource,
    portable,
)
from .executor import (
    BlockPrefetcher,
    StreamStats,
    budgeted_submit,
    locality_map_stream,
)

def _check_executor(executor: str, fn, what: str) -> None:
    if executor not in ("thread", "process"):
        raise ValueError(f"executor must be 'thread' or 'process', not {executor!r}")
    if executor == "process":
        from ..core.worker_pool import check_importable

        check_importable(fn, what)


@dataclasses.dataclass
class ActorPoolStrategy:
    """compute= strategy for map_batches: a pool of stateful actors
    instead of stateless tasks (reference ActorPoolMapOperator). Use with
    a CLASS udf whose (expensive) __init__ runs once per actor — model
    weights, tokenizers — and whose __call__ maps a block.

    executor="process" hosts each actor in its own OS worker process
    (GIL-free: CPU-bound udfs scale with cores)."""

    size: int = 2
    executor: str = "thread"


@dataclasses.dataclass
class DataContext:
    """Execution knobs (reference DataContext, data/context.py:226)."""

    prefetch_blocks: int = 4  # in-flight tasks per stage = backpressure window
    split_buffer_blocks: int = 4  # staged refs per split in streaming_split
    target_batch_prefetch: int = 2  # device batches in flight
    # byte-measured half of the in-flight window: a stage stops
    # submitting once its pending outputs are estimated past this many
    # bytes (None = count-only windows). 64 MiB default keeps ~16 4 MiB
    # blocks in flight per stage. Unsealed outputs count as the source's
    # declared block size (Datasource.estimated_block_nbytes) or, when
    # undeclared, the max size sealed so far — so the bound is exact for
    # uniform blocks and can transiently overshoot on heterogeneous ones
    # (the spill path absorbs the difference).
    target_inflight_bytes: Optional[int] = 64 << 20
    # memory-pressure backoff: when the object store's host bytes exceed
    # this fraction of capacity, submitters stall (bounded) before
    # riding the spill path
    store_pressure_fraction: float = 0.9
    backpressure_max_stall_s: float = 2.0  # max stall per submission
    locality_aware: bool = True  # hint map tasks onto block-holding nodes

    _default: ClassVar[Optional["DataContext"]] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._default is None:
            cls._default = cls()
        return cls._default


# ---------------------------------------------------------------- logical ops


@dataclasses.dataclass
class _Op:
    kind: str  # read | read_stream | map_batches | map_batches_actors |
    #            filter | repartition | shuffle | limit
    fn: Optional[Callable] = None
    source: Optional[Datasource] = None
    n: Optional[int] = None
    seed: Optional[int] = None
    compute: Optional[ActorPoolStrategy] = None
    fn_args: tuple = ()
    fn_kwargs: Optional[Dict[str, Any]] = None
    # "thread" (zero-copy, GIL-shared) or "process" (pooled OS workers,
    # GIL-free CPU parallelism) for stateless map / filter stages
    executor: str = "thread"


class _RowMap:
    """`Dataset.map`'s block function: a module-level class, so a process
    worker can unpickle it (a closure would not pickle)."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = "apply"

    def __call__(self, block: Block) -> Block:
        return block_from_items([self.fn(row) for row in block_to_items(block)])


class _FilterBlock:
    """`Dataset.filter`'s block function (module-level, as _RowMap)."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = "filter_block"

    def __call__(self, block: Block) -> Block:
        keep = np.asarray([bool(self.fn(row)) for row in block_to_items(block)])
        return block_take(block, np.nonzero(keep)[0]) if len(keep) else block


class _BlockUDFActor:
    """Actor body hosting one stateful udf instance (class or callable)."""

    def __init__(self, fn_or_cls, args, kwargs):
        if isinstance(fn_or_cls, type):
            self.fn = fn_or_cls(*args, **(kwargs or {}))
        else:
            self.fn = fn_or_cls

    def apply(self, block: Block) -> Block:
        return self.fn(block)


# ----------------------------------------------------------------- execution


def _run_read_task(task):
    return task()


def _stream_submit(
    items: Iterator[Callable[[], Any]], submit: Callable, window: int
) -> Iterator[Any]:
    """Submit with a bounded in-flight window; yield refs in order."""
    pending: deque = deque()
    for item in items:
        pending.append(submit(item))
        if len(pending) >= window:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def _actor_pool_stream(
    stream: Iterator[Any], op: _Op, ctx: DataContext
) -> Iterator[Any]:
    """Stateful map over an actor pool: blocks round-robin across N udf
    actors (in-order yield; the in-flight window is the backpressure).
    Actors are killed when the stage drains."""
    actor_cls = api.remote(_BlockUDFActor)
    pool = [
        actor_cls.options(num_cpus=1, executor=op.compute.executor).remote(
            op.fn, op.fn_args, op.fn_kwargs)
        for _ in builtins.range(op.compute.size)  # module range() is a Dataset
    ]
    produced: deque = deque()

    def submit(ref):
        out = pool[next(counter) % len(pool)].apply.remote(ref)
        produced.append(out)
        # keep only a bounded completion tail: pinning EVERY output ref
        # for the stage's lifetime would defeat store GC on large datasets
        while len(produced) > 4 * max(ctx.prefetch_blocks, len(pool)):
            oldest = produced[0]
            api.wait([oldest], num_returns=1, timeout=300)
            produced.popleft()
        return out

    try:
        counter = itertools.count()
        yield from _stream_submit(
            stream, submit, max(ctx.prefetch_blocks, len(pool))
        )
    finally:
        # downstream stages may still be EXECUTING the yielded refs; a
        # kill now would fail them with ActorDiedError mid-pipeline. Let
        # every submitted apply() finish before releasing the actors.
        if produced:
            api.wait(list(produced), num_returns=len(produced), timeout=300)
        for a in pool:
            api.kill(a)


def _plan_iter(ops: List[_Op], ctx: DataContext, stats: StreamStats) -> Iterator[Any]:
    """Compose the per-op ref streams (each stage overlaps with the next).

    Every stage submits tasks whose outputs stay as refs in the object
    store; the byte-budgeted window (executor.py) is the backpressure,
    and map-like stages carry locality hints so they run where their
    input block was produced."""
    from ..util.events import emit

    assert ops and ops[0].kind in ("read", "read_stream")
    for op in ops:
        emit("INFO", "data", f"stage {op.kind} submitting",
             kind="data.stage_start", stage=op.kind)
    if ops[0].kind == "read_stream":
        # unknown-cardinality ingest: ONE streaming-generator task yields
        # blocks as they are produced (num_returns="streaming" substrate)
        gen_fn = ops[0].fn

        def produce():
            for batch in gen_fn():
                yield batch if isinstance(batch, dict) else block_from_items(batch)

        produce_remote = api.remote(produce)
        stream = iter(
            produce_remote.options(
                num_returns="streaming",
                # consumer-paced: the producer blocks once this many blocks
                # sit unread (the streaming read path's backpressure window)
                stream_max_backlog=ctx.prefetch_blocks,
            ).remote()
        )
    else:
        # a portable read task may run on any node; a closure stays here
        read_anywhere = api.remote(_run_read_task)
        read_here = api.remote(lambda task: task())
        stream = budgeted_submit(
            iter(ops[0].source.read_tasks()),
            lambda t: (read_anywhere if portable(t) else read_here).remote(t),
            stats=stats,
            count_window=ctx.prefetch_blocks,
            byte_budget=ctx.target_inflight_bytes,
            pressure_fraction=ctx.store_pressure_fraction,
            max_stall_s=ctx.backpressure_max_stall_s,
            # sources that know their block size declare it, so the byte
            # window binds from the FIRST submission instead of only
            # after a block seals
            est_bytes=ops[0].source.estimated_block_nbytes(),
        )

    for op in ops[1:]:
        if op.kind == "map_batches":
            stream = locality_map_stream(
                stream, api.remote(op.fn).options(executor=op.executor), stats=stats,
                ctx=ctx, locality=ctx.locality_aware,
            )
        elif op.kind == "map_batches_actors":
            stream = _actor_pool_stream(stream, op, ctx)
        elif op.kind == "filter":
            stream = locality_map_stream(
                stream, api.remote(_FilterBlock(op.fn)).options(executor=op.executor),
                stats=stats, ctx=ctx, locality=ctx.locality_aware,
            )
        elif op.kind == "limit":
            stream = _limit_stream(stream, op.n)
        elif op.kind == "shuffle":
            stream = _shuffle_stream(stream, op.seed, ctx)
        elif op.kind == "repartition":
            stream = _repartition_stream(stream, op.n)
        else:  # pragma: no cover
            raise ValueError(f"unknown op {op.kind}")

    def drained(s):
        try:
            yield from s
        finally:
            emit("INFO", "data", "pipeline drained",
                 kind="data.stage_finish", stage=ops[-1].kind)

    return drained(stream)


def _limit_stream(stream: Iterator[Any], n: int) -> Iterator[Any]:
    remaining = n
    for ref in stream:
        if remaining <= 0:
            return
        block = api.get(ref)
        rows = block_num_rows(block)
        if rows <= remaining:
            yield api.put(block)
            remaining -= rows
        else:
            yield api.put(block_slice(block, 0, remaining))
            remaining = 0
            return


def _shuffle_stream(stream: Iterator[Any], seed: Optional[int], ctx: DataContext) -> Iterator[Any]:
    """Materialize the stage boundary (shuffle is all-to-all), permute block
    order, and permute rows within each block — the standard two-level
    approximation; exact global shuffle = repartition(1).shuffle()."""
    refs = list(stream)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(refs))

    def shuffle_block(block: Block, block_seed: int) -> Block:
        r = np.random.default_rng(block_seed)
        return block_take(block, r.permutation(block_num_rows(block)))

    shuf_remote = api.remote(shuffle_block)
    seeds = rng.integers(0, 2**31, size=len(refs))
    reordered = ((refs[i], int(seeds[i])) for i in order)
    return _stream_submit(
        reordered, lambda pair: shuf_remote.remote(pair[0], pair[1]), ctx.prefetch_blocks
    )


def _repartition_stream(stream: Iterator[Any], n: int) -> Iterator[Any]:
    blocks = [api.get(r) for r in stream]
    if not blocks:
        return iter(())
    merged = block_concat(blocks)
    total = block_num_rows(merged)
    edges = np.linspace(0, total, n + 1, dtype=np.int64)
    return iter(
        [
            api.put(block_slice(merged, int(lo), int(hi)))
            for lo, hi in zip(edges[:-1], edges[1:])
        ]
    )


# -------------------------------------------------------------- torch batches


class DeviceBatch(dict):
    """A batch of device tensors (column -> tensor). `ready` is the event
    its copies recorded on the side stream (None on the CPU): waiting on
    it lands the batch on the host's clock without waiting for the
    consumer's queued work. `pin_s` and `enqueue_s` are the host seconds
    the batch spent pinning its columns and enqueuing their copies (0.0
    on the CPU)."""

    ready: Optional[torch.cuda.Event] = None
    pin_s: float = 0.0
    enqueue_s: float = 0.0
    sharding: Any = None  # the NamedSharding that placed this rank's block, if any


def _torch_batch_stream(
    batch_iter: Iterator[Block],
    prefetch: int,
    device: Union[str, torch.device],
    columns: Optional[List[str]],
    dtypes: Optional[Dict[str, Any]] = None,
    sharding: Any = None,
) -> Iterator[DeviceBatch]:
    """Device-prefetch window over a host batch iterator on `device`
    (resolved now: a missing CUDA device raises here, not at the first
    batch). The FIRST batch yields the moment its copy is enqueued, then
    the window tops up to `prefetch` batches behind the consumer's step —
    overlap without paying the whole window before step 0. `dtypes`
    converts columns once they are on the device, on the consumer's
    stream. `sharding` (a `parallel.NamedSharding`) places each column's
    block for this rank on the mesh's device, as JAX's `device_put(v,
    sharding)` places a global batch: only that block is copied."""
    dev = sharding.mesh.device if sharding is not None else resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def to_device(batch: Block):
        sel = {k: batch[k] for k in (columns or batch.keys())}
        if sharding is not None:
            sel = {k: sharding.shard(v) for k, v in sel.items()}
        if side is None:
            out = DeviceBatch({k: torch.as_tensor(np.ascontiguousarray(v))
                               for k, v in sel.items()})
            out.sharding = sharding
            return out, ()
        t0 = time.perf_counter()
        hosts = [torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for v in sel.values()]
        t1 = time.perf_counter()
        with torch.cuda.stream(side):
            out = DeviceBatch({k: h.to(dev, non_blocking=True) for k, h in zip(sel, hosts)})
            out.ready = torch.cuda.Event()
            out.ready.record(side)
        out.pin_s, out.enqueue_s = t1 - t0, time.perf_counter() - t1
        out.sharding = sharding
        return out, hosts

    def hand_over(entry) -> DeviceBatch:
        out, _hosts = entry  # the pinned sources die with the entry, after the copies' event
        if side is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(out.ready)
            for t in out.values():
                t.record_stream(consumer)
        for k in (dtypes or {}):
            if k in out:
                out[k] = out[k].to(dtypes[k])
        return out

    def stream() -> Iterator[DeviceBatch]:
        it = iter(batch_iter)
        window: deque = deque()
        exhausted = False

        def top_up(target: int) -> None:
            nonlocal exhausted
            while not exhausted and len(window) < target:
                try:
                    window.append(to_device(next(it)))
                except StopIteration:
                    exhausted = True

        top_up(1)  # time-to-first-step pays ONE transfer, not the window
        while window:
            yield hand_over(window.popleft())
            top_up(max(1, prefetch))

    return stream()


# -------------------------------------------------------------------- Dataset


class Dataset:
    """Lazy, streaming, immutable. Transformations return new Datasets;
    consumption (iter_*, take, count, materialize) triggers execution."""

    def __init__(self, ops: List[_Op], ctx: Optional[DataContext] = None):
        self._ops = ops
        self._ctx = ctx or DataContext.get_current()
        self._last_stats: Optional[StreamStats] = None

    # -- transforms (lazy) --

    def map_batches(
        self,
        fn: Callable[[Block], Block] | type,
        *,
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[Dict[str, Any]] = None,
        executor: str = "thread",
    ) -> "Dataset":
        """Map blocks with a function (stateless thread tasks) or, with
        compute=ActorPoolStrategy(n), a CLASS udf hosted on a pool of n
        stateful actors — __init__ runs once per actor (reference
        ActorPoolMapOperator).

        executor="process" runs the udf in pooled OS worker processes
        (GIL-free: CPU-bound udfs get real multi-core scaling); with
        compute=, pass the executor on the strategy instead. A process
        udf must be importable in the worker: a lambda, a nested function
        or a function in __main__ raises TypeError here."""
        if compute is not None:
            if executor != "thread":
                raise ValueError(
                    "pass the executor on the strategy instead: "
                    "compute=ActorPoolStrategy(n, executor='process') — the "
                    "executor= kwarg only applies to stateless task maps"
                )
            _check_executor(compute.executor, fn, "a map_batches udf")
            return Dataset(
                self._ops + [_Op(
                    "map_batches_actors", fn=fn, compute=compute,
                    fn_args=fn_constructor_args,
                    fn_kwargs=fn_constructor_kwargs,
                )],
                self._ctx,
            )
        if isinstance(fn, type):
            raise ValueError(
                "class udfs need compute=ActorPoolStrategy(n) so instances "
                "have somewhere stateful to live"
            )
        _check_executor(executor, fn, "a map_batches udf")
        return Dataset(self._ops + [_Op("map_batches", fn=fn, executor=executor)], self._ctx)

    def map(self, fn: Callable[[Any], Any], *, executor: str = "thread") -> "Dataset":
        _check_executor(executor, fn, "a map function")
        return self.map_batches(_RowMap(fn), executor=executor)

    def filter(self, fn: Callable[[Any], bool], *, executor: str = "thread") -> "Dataset":
        _check_executor(executor, fn, "a filter predicate")
        return Dataset(self._ops + [_Op("filter", fn=fn, executor=executor)], self._ctx)

    def limit(self, n: int) -> "Dataset":
        return Dataset(self._ops + [_Op("limit", n=n)], self._ctx)

    def repartition(self, n: int) -> "Dataset":
        return Dataset(self._ops + [_Op("repartition", n=n)], self._ctx)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        return Dataset(self._ops + [_Op("shuffle", seed=seed)], self._ctx)

    # -- consumption --

    def iter_block_refs(self) -> Iterator[Any]:
        self._last_stats = StreamStats(
            byte_budget=self._ctx.target_inflight_bytes)
        return _plan_iter(self._ops, self._ctx, self._last_stats)

    def stats(self) -> Optional[Dict[str, Any]]:
        """Counters for the most recent execution of this dataset
        (blocks/bytes produced+consumed, locality hit rate, backpressure
        stalls, spill/re-execution deltas) — None before any execution."""
        return self._last_stats.snapshot() if self._last_stats else None

    def iter_blocks(self) -> Iterator[Block]:
        # consumer-side prefetch: up to prefetch_blocks materialized
        # ahead of the consumer, overlapping fetch with its compute
        prefetcher = BlockPrefetcher(
            self.iter_block_refs(), self._ctx.prefetch_blocks,
            self._last_stats)
        try:
            yield from prefetcher
        finally:
            prefetcher.close()

    def iter_batches(
        self, batch_size: int, *, drop_last: bool = False
    ) -> Iterator[Block]:
        return batches_from_blocks(
            self.iter_blocks(), batch_size, drop_last=drop_last
        )

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from block_to_items(block)

    def iter_torch_batches(
        self,
        batch_size: int,
        *,
        drop_last: bool = False,  # reference default: keep the partial tail
        columns: Optional[List[str]] = None,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Union[str, torch.device] = "cuda",
        sharding: Any = None,
    ) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors (reference Dataset.iter_torch_batches).
        On a CUDA device (the default; raising without one) each batch
        rides a device-prefetch window: the next batch's copy to the card
        overlaps the current step, and the first batch yields as soon as
        its copy is enqueued (JAX's `iter_jax_batches`). On
        device="cpu" these are JAX's CPU tensors. `sharding=` places each
        batch per rank in a multihost gang (`parallel.data_sharding(mesh)`:
        this rank's rows, on the mesh's device), as `iter_jax_batches`
        does."""
        return _torch_batch_stream(
            self.iter_batches(batch_size, drop_last=drop_last),
            self._ctx.target_batch_prefetch, device, columns, dtypes, sharding,
        )

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def materialize(self) -> "Dataset":
        blocks = [b for b in self.iter_blocks()]
        return Dataset([_Op("read", source=_MaterializedSource(blocks))], self._ctx)

    def streaming_split(
        self, k: int, *, equal: bool = False, skip_ahead: bool = False
    ) -> List["DataIterator"]:
        """k iterators fed round-robin from one execution (reference
        Dataset.streaming_split → StreamSplitDataIterator).

        Ref-passing and per-consumer: the pump stages only BLOCK REFS —
        each consumer fetches its own blocks (with its own prefetch
        window), so no block bytes transit the pump.

        Distribution is STRICT round-robin by default: split i receives
        blocks i, i+k, i+2k, … regardless of consumer pacing, so
        data-parallel ranks see a deterministic share (±1 block) and a
        full buffer blocks the pump on that consumer — the right pacing
        for a gang, whose collectives hold ranks in lockstep anyway.

        equal=True additionally delivers only COMPLETE rounds of k
        blocks (a trailing partial round is dropped), so every split
        receives exactly the same number of blocks — the gang-feed
        setting: with fixed-size blocks and drop_last=True batching,
        every dp rank agrees on step counts.

        skip_ahead=True (independent consumers ONLY — never a gang)
        trades determinism for throughput: a ref bound for a full split
        lands on whichever sibling has room instead of stalling the
        pump, so one stalled consumer cannot head-of-line-block its
        siblings, but splits may receive unequal shares."""
        if equal and skip_ahead:
            raise ValueError(
                "equal=True guarantees identical per-split block counts; "
                "skip_ahead=True redistributes blocks — pick one"
            )
        state = _SplitState(k, self._ctx.split_buffer_blocks,
                            skip_ahead=skip_ahead)
        # building the plan is lazy (no tasks submitted until the first
        # pull), so create it here and share its StreamStats with every
        # consumer before the pump starts
        refs = self.iter_block_refs()
        stats = self._last_stats

        def pump():
            try:
                round_buf: List[Any] = []
                for i, ref in enumerate(refs):
                    if equal:
                        round_buf.append(ref)
                        if len(round_buf) == k:
                            for j, r in enumerate(round_buf):
                                state.push(j, r)
                            round_buf.clear()
                    else:
                        state.push(i % k, ref)
                state.finish(None)
            except _SplitClosed:
                # consumer-side close (gang shutdown / restart): stop
                # the upstream generator chain so budgeted_submit stops
                # submitting block tasks for a gang nobody will feed
                refs.close()
            except BaseException as e:  # propagate to all consumers
                state.finish(e)

        thread = threading.Thread(target=pump, daemon=True, name="data-split-pump")
        thread.start()
        return [
            DataIterator(state, i, self._ctx, stats)
            for i in builtins.range(k)
        ]


class _MaterializedSource(Datasource):
    def __init__(self, blocks: List[Block]):
        self.blocks = blocks

    def read_tasks(self):
        return [(lambda b=b: b) for b in self.blocks]


class _SplitClosed(Exception):
    """Raised out of _SplitState.push when a consumer closed the split:
    the pump's signal to stop pulling refs and shut the upstream chain."""


class _SplitState:
    """Ref router behind streaming_split: the pump stages BLOCK REFS
    (never bytes) into per-split staging deques; consumers pop refs and
    fetch blocks themselves. `cap` bounds staged refs per split so the
    pump's pull pace stays tied to consumption. Routing is strict
    round-robin unless `skip_ahead` (see Dataset.streaming_split)."""

    def __init__(self, k: int, cap: int, *, skip_ahead: bool = False):
        self._cv = threading.Condition()
        self._queues: List[deque] = [
            deque() for _ in builtins.range(k)
        ]  # guarded-by: _cv
        self._done = False  # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self._error: Optional[BaseException] = None  # guarded-by: _cv
        self._cap = max(int(cap), 1)
        self._skip_ahead = skip_ahead

    def push(self, i: int, ref: Any) -> None:
        with self._cv:
            while True:
                if self._closed:
                    raise _SplitClosed()
                if len(self._queues[i]) < self._cap:
                    self._queues[i].append(ref)
                    self._cv.notify_all()
                    return
                if self._skip_ahead:
                    # opt-in: route to any sibling with room rather than
                    # stalling every split behind the slowest consumer
                    # (non-deterministic shares — never for a gang)
                    for q in self._queues:
                        if len(q) < self._cap:
                            q.append(ref)
                            self._cv.notify_all()
                            return
                # the target split (strict) or every split (skip-ahead)
                # is full: the pump waits, which is what propagates
                # consumer pacing back up to submission
                self._cv.wait(timeout=1.0)

    def finish(self, error: Optional[BaseException]) -> None:
        with self._cv:
            self._done = True
            self._error = error
            self._cv.notify_all()

    def close(self) -> None:
        """Tear down the split: the pump's next push raises _SplitClosed
        (exiting the thread and closing the upstream submission chain),
        staged refs drop so their blocks can be GC'd, and every consumer
        sees end-of-stream."""
        with self._cv:
            self._closed = True
            self._done = True
            for q in self._queues:
                q.clear()
            self._cv.notify_all()

    def pop(self, i: int):
        with self._cv:
            while True:
                if self._queues[i]:
                    ref = self._queues[i].popleft()
                    self._cv.notify_all()
                    return ("ref", ref)
                if self._done:
                    if self._error is not None:
                        return ("error", self._error)
                    return ("end", None)
                self._cv.wait(timeout=1.0)


class DataIterator:
    """One consumer's view of a streaming_split: pops block REFS from
    its split and fetches the bytes through its own prefetch window
    (each rank pulls its own blocks; the pump never materializes them)."""

    def __init__(self, split: _SplitState, index: int,
                 ctx: Optional[DataContext] = None,
                 stats: Optional[StreamStats] = None):
        self._split = split
        self._index = index
        self._ctx = ctx or DataContext.get_current()
        self._stats = stats

    def _ref_iter(self) -> Iterator[Any]:
        while True:
            kind, payload = self._split.pop(self._index)
            if kind == "end":
                return
            if kind == "error":
                raise payload
            yield payload

    def iter_blocks(self) -> Iterator[Block]:
        prefetcher = BlockPrefetcher(
            self._ref_iter(), self._ctx.prefetch_blocks, self._stats)
        try:
            yield from prefetcher
        finally:
            prefetcher.close()

    def close(self) -> None:
        """Stop the split's SHARED execution (this iterator AND its
        siblings): the pump thread exits, staged refs drop, and the
        upstream submission chain closes so no further block tasks are
        submitted. WorkerGroup.shutdown calls this so a gang restart
        does not leak the previous attempt's pump thread, prefetchers,
        or in-flight blocks."""
        self._split.close()

    def iter_batches(self, batch_size: int, *, drop_last: bool = False) -> Iterator[Block]:
        """Same default as Dataset.iter_batches (keep the partial tail).
        Gang-feed paths pass drop_last=True explicitly (iter_torch_batches
        defaults to it) so data-parallel ranks always agree on step
        counts — a ragged last step deadlocks a multi-rank gang
        mid-collective."""
        return batches_from_blocks(self.iter_blocks(), batch_size, drop_last=drop_last)

    def iter_torch_batches(
        self,
        batch_size: int,
        *,
        drop_last: bool = True,
        columns: Optional[List[str]] = None,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Union[str, torch.device] = "cuda",
        sharding: Any = None,
    ) -> Iterator[Dict[str, Any]]:
        """Per-rank torch batches (see Dataset.iter_torch_batches), with
        JAX's `iter_jax_batches` default drop_last=True so gang ranks
        agree on step counts."""
        return _torch_batch_stream(
            self.iter_batches(batch_size, drop_last=drop_last),
            self._ctx.target_batch_prefetch, device, columns, dtypes, sharding,
        )

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from block_to_items(block)

    def stats(self) -> Optional[Dict[str, Any]]:
        return self._stats.snapshot() if self._stats else None


# ------------------------------------------------------------------- read API


def range(n: int, *, num_blocks: int = 8) -> Dataset:  # noqa: A001
    return Dataset([_Op("read", source=RangeSource(n, num_blocks))])


def from_items(items: Sequence[Any], *, num_blocks: int = 8) -> Dataset:
    return Dataset([_Op("read", source=ItemsSource(items, num_blocks))])


def from_numpy(arrays: Dict[str, Any], *, num_blocks: int = 8) -> Dataset:
    return Dataset([_Op("read", source=NumpySource(arrays, num_blocks))])


def read_text(paths) -> Dataset:
    return Dataset([_Op("read", source=TextSource(paths))])


def read_npy(paths, *, column: str = "tokens") -> Dataset:
    return Dataset([_Op("read", source=NpyFileSource(paths, column))])


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    try:
        import pyarrow  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_parquet requires pyarrow, which is not available in this "
            "environment; convert to .npy shards and use read_npy"
        ) from e
    return Dataset([_Op("read", source=ParquetSource(paths, columns))])


def read_csv(paths) -> Dataset:
    return Dataset([_Op("read", source=CsvSource(paths))])


def read_json(paths) -> Dataset:
    """Line-delimited JSON (one object per line ⇒ one row)."""
    return Dataset([_Op("read", source=JsonlSource(paths))])


def read_tfrecord(paths, *, parse: bool = True) -> Dataset:
    """TFRecord files; parse=True decodes tf.train.Example records into
    columns via the built-in wire-format parser (no tensorflow/protobuf
    runtime needed), parse=False yields raw record bytes."""
    return Dataset([_Op("read", source=TFRecordSource(paths, parse=parse))])


def read_images(paths, *, size=None, mode: str = "RGB",
                images_per_block: int = 64) -> Dataset:
    """Decode a directory/glob of images into 'image' + 'path' columns
    (PIL-gated)."""
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise ImportError("read_images requires Pillow") from e
    return Dataset([_Op("read", source=ImageDirSource(
        paths, size=size, mode=mode, images_per_block=images_per_block))])


def read_binary_files(paths, *, files_per_block: int = 32) -> Dataset:
    """Whole files as rows: 'bytes' + 'path' columns."""
    return Dataset([_Op("read", source=BinaryFilesSource(
        paths, files_per_block=files_per_block))])


def from_generator(gen_fn: Callable[[], Iterator[Any]]) -> Dataset:
    """Unknown-cardinality ingest: `gen_fn()` yields batches (a columnar
    dict or a list of rows), each becoming a block the moment it is
    produced — backed by a num_returns="streaming" generator task whose
    producer blocks once `prefetch_blocks` blocks sit unread, so
    consumers overlap with production (reference: streaming reads +
    ObjectRefStream)."""
    return Dataset([_Op("read_stream", fn=gen_fn)])
