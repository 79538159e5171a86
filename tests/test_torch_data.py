"""ray_tpu_torch's data plane against ray_tpu's on the CPU.

Each test runs one program through both packages' runtimes
(`init(num_cpus=4, detect_accelerators=False)`, `num_nodes=4` where
placement matters) on the same numpy inputs and temp files, and compares
what comes out: every datasource's blocks, every Dataset op's output
blocks (exact: `np.array_equal` and equal dtypes, element by element for
object columns), the per-rank block sequences of `streaming_split`, the
byte-budgeted window's peak against its budget, `StreamStats`' keys,
actor pools, `ActorPool` / `Queue`, `iter_torch_batches(device="cpu")`,
the store's pins and `list_objects`' `pin_count`, and the runtime's
`stream_max_backlog` and `locality_hint`; the process executor's map
stages, filters and actor pools (their udfs from the root module
`torch_process_udfs.py`), their outputs equal to JAX's and never run in
the calling process. Waits are events and joins with timeouts, never sleeps
compared to a threshold.
"""

import builtins
import json
import os
import struct
import threading

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
import torch_process_udfs as U
from ray_tpu import data as jdata
from ray_tpu.core import runtime as jruntime
from ray_tpu.data import dataset as jdataset
from ray_tpu.data import executor as jexecutor
from ray_tpu.util import ActorPool as JActorPool
from ray_tpu.util import Empty as JEmpty
from ray_tpu.util import Full as JFull
from ray_tpu.util import Queue as JQueue
from ray_tpu.util import state as jstate
from ray_tpu_torch import data as tdata
from ray_tpu_torch.core import runtime as truntime
from ray_tpu_torch.data import dataset as tdataset
from ray_tpu_torch.data import executor as texecutor
from ray_tpu_torch.util import ActorPool as TActorPool
from ray_tpu_torch.util import Empty as TEmpty
from ray_tpu_torch.util import Full as TFull
from ray_tpu_torch.util import Queue as TQueue
from ray_tpu_torch.util import state as tstate

TIMEOUT = 30


class _Pkg:
    """One package's runtime and data-plane modules under one name."""

    def __init__(self, name, rt, data, dataset, executor, actor_pool, queue, empty, full, state):
        self.name, self.rt, self.data, self.dataset, self.executor = name, rt, data, dataset, executor
        self.ActorPool, self.Queue, self.Empty, self.Full, self.state = (
            actor_pool, queue, empty, full, state)


PKGS = [
    _Pkg("jax", ray_tpu, jdata, jdataset, jexecutor, JActorPool, JQueue, JEmpty, JFull, jstate),
    _Pkg("torch", ray_tpu_torch, tdata, tdataset, texecutor, TActorPool, TQueue, TEmpty, TFull,
         tstate),
]


def _both(program, **init):
    """Run `program(pkg)` under each package's runtime; returns
    {name: outcome}."""
    out = {}
    for pkg in PKGS:
        pkg.rt.init(**{"num_cpus": 4, "detect_accelerators": False, **init})
        try:
            out[pkg.name] = program(pkg)
        finally:
            pkg.rt.shutdown()
    return out


@pytest.fixture(autouse=True)
def _no_runtime_left():
    yield
    for pkg in PKGS:
        pkg.rt.shutdown()
    assert not truntime.is_initialized() and not jruntime.is_initialized()


def _assert_value_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        _assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _assert_array_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype == object:
        for x, y in zip(a, b):
            _assert_value_equal(x, y)
    else:
        assert np.array_equal(a, b)


def _assert_blocks_equal(jax_blocks, torch_blocks):
    assert len(jax_blocks) == len(torch_blocks)
    for x, y in zip(jax_blocks, torch_blocks):
        assert list(x) == list(y)
        for k in x:
            _assert_array_equal(x[k], y[k])


def _same_blocks(program, **init):
    out = _both(program, **init)
    _assert_blocks_equal(out["jax"], out["torch"])
    return out["torch"]


# -------------------------------------------------------------- datasources


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _example(ints, floats, blob) -> bytes:
    feats = {
        "label": _ld(3, _ld(1, b"".join(_varint(int(v)) for v in ints))),
        "score": _ld(2, _ld(1, np.asarray(floats, dtype="<f4").tobytes())),
        "blob": _ld(1, _ld(1, blob)),
    }
    entries = b"".join(_ld(1, _ld(1, k.encode()) + _ld(2, v)) for k, v in feats.items())
    return _ld(1, entries)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same files for both packages, made from a seed."""
    from PIL import Image
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(0)
    out = {}
    d = root / "npy"
    d.mkdir()
    for i in range(3):
        np.save(d / f"shard{i}.npy", rng.integers(0, 50257, 257 + i, dtype=np.int32))
    out["npy"] = str(d)
    d = root / "text"
    d.mkdir()
    for i in range(2):
        (d / f"t{i}.txt").write_text("".join(f"line {i}.{j}\n" for j in range(5)))
    out["text"] = str(d / "*.txt")
    (root / "t.csv").write_text("a,b,name,big\n1,2.5,x,9007199254740993\n3,4.5,y,-7\n")
    out["csv"] = str(root / "t.csv")
    (root / "t.jsonl").write_text("".join(
        json.dumps({"x": i, "y": f"p{i}", **({"z": 1.5} if i % 2 else {})}) + "\n" for i in range(4)))
    out["json"] = str(root / "t.jsonl")
    with open(root / "e.tfrecord", "wb") as f:
        for i in range(3):
            rec = _example([i, -i - 1], [0.5 * i], bytes([65 + i]))
            f.write(struct.pack("<Q", len(rec)) + b"\0" * 4 + rec + b"\0" * 4)
    out["tfrecord"] = str(root / "e.tfrecord")
    d = root / "img"
    d.mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (8, 6 + i, 3), dtype=np.uint8)).save(d / f"i{i}.png")
    out["images"] = str(d)
    d = root / "bin"
    d.mkdir()
    for i in range(3):
        (d / f"b{i}.bin").write_bytes(bytes(rng.integers(0, 255, 5 + i, dtype=np.uint8)))
    out["binary"] = str(d)
    d = root / "parquet"
    d.mkdir()
    for shard in range(2):
        table = pa.table({"x": np.arange(shard * 10, shard * 10 + 10),
                          "s": [f"r{j}" for j in range(10)]})
        pq.write_table(table, d / f"part-{shard}.parquet", row_group_size=4)
    out["parquet"] = str(d)
    return out


SOURCES = {
    "range": lambda data, f: data.range(103, num_blocks=7),
    "items": lambda data, f: data.from_items([{"a": i, "b": str(i)} for i in range(11)], num_blocks=3),
    "items_scalar": lambda data, f: data.from_items(list(builtins.range(9)), num_blocks=4),
    "numpy": lambda data, f: data.from_numpy(
        {"x": np.arange(20, dtype=np.float32).reshape(10, 2), "y": np.arange(10)}, num_blocks=3),
    "npy": lambda data, f: data.read_npy(f["npy"]),
    "text": lambda data, f: data.read_text(f["text"]),
    "csv": lambda data, f: data.read_csv(f["csv"]),
    "json": lambda data, f: data.read_json(f["json"]),
    "tfrecord": lambda data, f: data.read_tfrecord(f["tfrecord"]),
    "tfrecord_raw": lambda data, f: data.read_tfrecord(f["tfrecord"], parse=False),
    "images_ragged": lambda data, f: data.read_images(f["images"], images_per_block=2),
    "images_sized": lambda data, f: data.read_images(f["images"], size=(5, 4)),
    "binary": lambda data, f: data.read_binary_files(f["binary"], files_per_block=2),
    "parquet": lambda data, f: data.read_parquet(f["parquet"]),
    "parquet_columns": lambda data, f: data.read_parquet(f["parquet"], columns=["s"]),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_datasource_blocks_match_jax(files, source):
    _same_blocks(lambda pkg: list(SOURCES[source](pkg.data, files).iter_blocks()))


# ------------------------------------------------------------- dataset ops


def _big(data):
    return data.from_numpy({"tokens": np.arange(4000, dtype=np.int32) * 7 % 1009,
                            "f": np.linspace(0, 1, 4000, dtype=np.float32)}, num_blocks=10)


class _AddOffset:
    """A stateful udf: __init__ once per actor."""

    def __init__(self, offset):
        self.offset = offset

    def __call__(self, block):
        return {"item": block["item"] + self.offset}


OPS = {
    "map_batches": lambda data: _big(data).map_batches(
        lambda b: {"tokens": (b["tokens"] * 3 + 1) % 251, "f": b["f"] * 2}),
    "map": lambda data: data.range(50, num_blocks=5).map(lambda r: {"sq": int(r) ** 2, "r": r}),
    "filter": lambda data: data.range(100, num_blocks=8).filter(lambda r: r % 3 == 0),
    "limit": lambda data: _big(data).limit(1234),
    "repartition": lambda data: _big(data).repartition(3),
    "random_shuffle": lambda data: _big(data).random_shuffle(seed=7),
    "chain": lambda data: data.range(300, num_blocks=6).map_batches(
        lambda b: {"item": b["item"] * 2}).filter(lambda r: r % 4 == 0).random_shuffle(seed=3)
        .limit(60).repartition(4),
    "materialize": lambda data: _big(data).map_batches(
        lambda b: {"tokens": b["tokens"] + 1}).materialize().limit(2500),
    "actor_pool": lambda data: data.range(64, num_blocks=8).map_batches(
        _AddOffset, compute=data.ActorPoolStrategy(size=2), fn_constructor_args=(1000,)),
    "from_generator": lambda data: data.from_generator(
        lambda: ({"x": np.arange(i * 5, i * 5 + 5)} if i % 2 else [{"x": i}, {"x": -i}]
                 for i in builtins.range(9))),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_dataset_op_blocks_match_jax(op):
    _same_blocks(lambda pkg: list(OPS[op](pkg.data).iter_blocks()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batches_from_blocks_match_jax(seed):
    """Random block sizes (empty ones included), batch sizes and drop_last:
    the same batches; a batch is its own memory (writing to it leaves the
    source block as it was), as JAX's is."""
    from ray_tpu.data.block import batches_from_blocks as jbatches
    from ray_tpu_torch.data.block import batches_from_blocks as tbatches

    rng = np.random.default_rng(seed)
    for _ in builtins.range(50):
        sizes = rng.integers(0, 30, rng.integers(0, 8))
        blocks = [{"a": rng.integers(0, 100, (n, 3)), "b": rng.random(n)} for n in sizes]
        size, drop_last = int(rng.integers(1, 12)), bool(rng.integers(0, 2))
        keep = [{k: v.copy() for k, v in b.items()} for b in blocks]
        jout = list(jbatches(iter(blocks), size, drop_last=drop_last))
        tout = list(tbatches(iter(blocks), size, drop_last=drop_last))
        _assert_blocks_equal(jout, tout)
        for batch in tout:
            batch["a"][...] = -1
        _assert_blocks_equal(keep, blocks)


def test_consumers_match_jax():
    def program(pkg):
        ds = pkg.data.range(103, num_blocks=4)
        return (
            [{k: v for k, v in b.items()} for b in ds.iter_batches(10)]
            + list(ds.iter_batches(25, drop_last=True)),
            [int(r) for r in ds.iter_rows()], [int(r) for r in ds.take(7)], ds.count(),
            sorted(ds.stats()),
        )

    out = _both(program)
    _assert_blocks_equal(out["jax"][0], out["torch"][0])
    assert out["jax"][1:] == out["torch"][1:]


def test_process_executor_raises_naming_a5():
    """The port's process executor (ROADMAP A5, done) refuses, when the
    stage is built, a udf that a worker could not import: the standard
    pickle sends it by reference (JAX's cloudpickle would carry the
    lambda). Importable udfs build lazily in both packages."""
    with pytest.raises(TypeError, match="module level"):
        tdata.range(4).map_batches(lambda b: b, executor="process")
    with pytest.raises(TypeError, match="module level"):
        tdata.range(4).filter(lambda r: True, executor="process")
    with pytest.raises(TypeError, match="module level"):
        tdata.range(4).map(lambda r: r, executor="process")
    with pytest.raises(ValueError, match="executor"):
        tdata.range(4).map_batches(U.tag_pid, executor="fork")
    for data in (jdata, tdata):
        with pytest.raises(ValueError, match="ActorPoolStrategy"):
            data.range(4).map_batches(_AddOffset)
        with pytest.raises(ValueError, match="executor"):
            data.range(4).map_batches(U.Tagger, executor="process",
                                      compute=data.ActorPoolStrategy(2))
        data.range(4).map_batches(_AddOffset, compute=data.ActorPoolStrategy(executor="process"))
        data.range(4).filter(bool, executor="process")


# ---------------------------------------------------------- process executor


def test_map_batches_process_executor_runs_in_workers():
    def program(pkg):
        ds = pkg.data.from_numpy({"x": np.arange(64)}, num_blocks=4)
        blocks = list(ds.map_batches(U.tag_pid, executor="process").iter_blocks())
        pids = set(np.concatenate([b.pop("pid") for b in blocks]).tolist())
        return blocks, pids

    out = _both(program)
    _assert_blocks_equal(out["jax"][0], out["torch"][0])
    for _, pids in out.values():
        assert pids and os.getpid() not in pids


def test_actor_pool_process_executor():
    def program(pkg):
        ds = pkg.data.from_numpy({"x": np.arange(32)}, num_blocks=4)
        blocks = list(ds.map_batches(
            U.Tagger, compute=pkg.data.ActorPoolStrategy(size=2, executor="process"),
            fn_constructor_args=(100,)).iter_blocks())
        pids = set(np.concatenate([b.pop("pid") for b in blocks]).tolist())
        return blocks, len(pids), os.getpid() in pids

    out = _both(program)
    _assert_blocks_equal(out["jax"][0], out["torch"][0])
    assert out["jax"][1:] == out["torch"][1:] == (2, False)


def test_process_filter_and_map_match_jax():
    def program(pkg):
        ds = pkg.data.from_numpy({"x": np.arange(40)}, num_blocks=4)
        return list(ds.filter(U.is_even, executor="process")
                    .map(U.row_plus, executor="process").iter_blocks())

    _same_blocks(program)


def test_process_stage_over_the_arena_equals_jax_thread_stage():
    """The chip phase's ingest UDF at a tiny size: the port's process stage,
    its blocks in the arena (read-only views in the workers), against
    JAX's thread stage on the same corpus, bitwise."""
    rng = np.random.default_rng(3)
    words = np.array([b"Alpha,", b"beta", b"GAMMA!", b"12345", b"delta.", b"(eps)"], dtype=object)
    text = np.zeros((48, 256), np.uint8)
    lens = np.zeros(48, np.int32)
    for d in range(48):
        doc = b" ".join(words[rng.integers(0, len(words), 40)])[:256]
        text[d, :len(doc)] = np.frombuffer(doc, np.uint8)
        lens[d] = len(doc)

    def program(pkg):
        ds = pkg.data.from_numpy({"text": text, "len": lens}, num_blocks=4)
        executor = "process" if pkg.name == "torch" else "thread"
        blocks = list(ds.map_batches(U.tokenize_pack, executor=executor).iter_blocks())
        stats = pkg.rt.core.runtime.get_runtime().object_store.stats
        return blocks, stats.get("shm_puts", 0)

    out = _both(program, _system_config={"native_store": True, "shm_min_bytes": 1024})
    _assert_blocks_equal(out["jax"][0], out["torch"][0])
    assert sum(b["tokens"].size for b in out["torch"][0]) > 0
    # the port's read blocks (12 KiB of text) and token blocks entered its
    # arena; JAX's arena takes bare arrays only, never a block
    assert out["torch"][1] >= 4 and out["jax"][1] == 0


# ---------------------------------------------------------- streaming_split


def _consume_splits(splits):
    """Drain every split on its own thread (gang-shaped consumption)."""
    results = [None] * len(splits)

    def consume(i):
        results[i] = [b["item"].tolist() for b in splits[i].iter_blocks()]

    threads = [threading.Thread(target=consume, args=(i,)) for i in builtins.range(len(splits))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "split consumer hung"
    return results


@pytest.mark.parametrize("k,equal", [(2, False), (3, False), (2, True), (3, True)])
def test_streaming_split_rank_sequences_match_jax(k, equal):
    def program(pkg):
        return _consume_splits(pkg.data.range(130, num_blocks=13).streaming_split(k, equal=equal))

    out = _both(program)
    assert out["jax"] == out["torch"]
    counts = [len(r) for r in out["torch"]]
    assert (len(set(counts)) == 1) if equal else (sum(counts) == 13)


def test_streaming_split_skip_ahead_and_close_match_jax():
    def program(pkg):
        ds = pkg.data.range(600, num_blocks=12)
        left, right = ds.streaming_split(2, skip_ahead=True)
        right_rows = [int(r) for r in right.iter_rows()]
        left_rows = [int(r) for r in left.iter_rows()]
        skip = (len(right_rows) > 300, sorted(left_rows + right_rows) == list(builtins.range(600)))
        with pytest.raises(ValueError):
            ds.streaming_split(2, equal=True, skip_ahead=True)
        for t in threading.enumerate():
            if t.name == "data-split-pump":
                t.join(timeout=10)  # the drained split's pump ends with its stream
        # close() ends the shared execution: the pump exits, siblings end
        a, b = pkg.data.range(1200, num_blocks=24).streaming_split(2)
        next(iter(a.iter_blocks()))
        pumps = [t for t in threading.enumerate() if t.name == "data-split-pump"]
        a.close()
        for t in pumps:
            t.join(timeout=10)
        return skip, len(pumps), any(t.is_alive() for t in pumps), list(b.iter_blocks())

    out = _same(program)
    assert out == ((True, True), 1, False, [])


def _same(program, **init):
    out = _both(program, **init)
    assert out["jax"] == out["torch"], out
    return out["torch"]


# ------------------------------------------------------- executor substrate


def test_budgeted_window_peak_spill_and_stats_match_jax(tmp_path):
    """A store of 256 KiB and a byte budget of 640 KiB: both packages ride
    the spill path, keep the in-flight window at or under the budget and
    produce the unconstrained run's rows exactly."""
    budget = 640 << 10

    def big(data):
        rng = np.random.default_rng(11)
        return data.from_numpy({"tokens": rng.integers(0, 255, 12 * 32768).astype(np.int32)},
                               num_blocks=12).map_batches(
            lambda b: {"tokens": (b["tokens"] * 3 + 1) % 251})

    want = _same_blocks(lambda pkg: list(big(pkg.data).iter_blocks()), num_nodes=2)

    def program(pkg):
        ctx = pkg.dataset.DataContext.get_current()
        saved = (ctx.target_inflight_bytes, ctx.backpressure_max_stall_s)
        ctx.target_inflight_bytes, ctx.backpressure_max_stall_s = budget, 0.5
        try:
            ds = big(pkg.data)
            blocks = list(ds.iter_blocks())
            return blocks, ds.stats()
        finally:
            ctx.target_inflight_bytes, ctx.backpressure_max_stall_s = saved

    out = {}
    for pkg in PKGS:
        spill = tmp_path / pkg.name
        pkg.rt.init(num_cpus=4, num_nodes=2, detect_accelerators=False,
                    object_store_capacity=256 << 10, spill_dir=str(spill))
        try:
            out[pkg.name] = program(pkg)
        finally:
            pkg.rt.shutdown()
    _assert_blocks_equal(out["jax"][0], out["torch"][0])
    _assert_blocks_equal(want, out["torch"][0])
    jstats, tstats = out["jax"][1], out["torch"][1]
    assert sorted(jstats) == sorted(tstats)
    for stats in (jstats, tstats):
        assert stats["spilled_bytes"] > 0, stats
        assert 0 < stats["max_inflight_bytes"] <= budget, stats
        assert stats["byte_budget"] == budget
    # bytes_produced counts an output not sealed when the window yields it
    # at the stage's estimate: it depends on timing, the other counts do not
    for key in ("blocks_produced", "blocks_consumed", "bytes_consumed"):
        assert jstats[key] == tstats[key], (key, jstats, tstats)
    assert texecutor.StreamStats(byte_budget=1234).snapshot() == \
        jexecutor.StreamStats(byte_budget=1234).snapshot()


def test_budgeted_submit_window_matches_jax():
    """budgeted_submit alone over put blocks of 1000 bytes: the count
    window and the byte budget each close the window where JAX's does."""

    def program(pkg):
        out = []
        for count, budget in ((8, 3000), (2, None), (8, 500)):
            stats = pkg.executor.StreamStats(byte_budget=budget)
            refs = list(pkg.executor.budgeted_submit(
                iter(builtins.range(6)),
                lambda i: pkg.rt.put(np.full(250, i, dtype=np.int32)),
                stats=stats, count_window=count, byte_budget=budget))
            snap = stats.snapshot()
            out.append(([int(pkg.rt.get(r)[0]) for r in refs], snap["max_inflight_bytes"],
                        snap["blocks_produced"], snap["bytes_produced"]))
        return out

    assert _same(program) == [(list(builtins.range(6)), 3000, 6, 6000),
                              (list(builtins.range(6)), 2000, 6, 6000),
                              (list(builtins.range(6)), 1000, 6, 6000)]


def test_locality_hints_and_hit_rate_match_jax():
    def program(pkg):
        rt = pkg.rt.core.runtime.get_runtime()
        nodes = [n.node_id for n in rt.scheduler.nodes()]
        node_cls = type(nodes[0])

        @pkg.rt.remote
        def where():
            return True

        refs = [where.options(locality_hint=node_cls(nodes[-1].hex())).remote() for _ in range(5)]
        pkg.rt.get(refs, timeout=TIMEOUT)
        ids = {r.object_id.task_id().hex() for r in refs}
        placed = [nodes.index(node_cls(ev["node"])) for ev in rt.task_events() if ev["task_id"] in ids]
        ds = pkg.data.range(1000, num_blocks=10).map_batches(lambda b: {"item": b["item"] * 2})
        count = ds.count()
        stats = ds.stats()
        block_refs = list(pkg.data.range(40, num_blocks=4).iter_block_refs())
        pkg.rt.get(block_refs, timeout=TIMEOUT)
        holders = [pkg.executor.node_holding(r) for r in block_refs]
        return (placed, count, stats["locality_total"] > 0, stats["locality_hit_rate"],
                all(h in {n.hex() for n in nodes} for h in holders))

    assert _same(program, num_nodes=4) == ([3] * 5, 1000, True, 1.0, True)


def test_stream_max_backlog_holds_the_producer_like_jax():
    """With stream_max_backlog=2 and no reads, the producer yields items 0
    and 1, computes item 2 and blocks before sealing it: item 3 is never
    started until the consumer reads."""

    def program(pkg):
        started = [threading.Event() for _ in builtins.range(6)]

        @pkg.rt.remote
        def produce():
            for i in builtins.range(6):
                started[i].set()
                yield i

        gen = produce.options(num_returns="streaming", stream_max_backlog=2).remote()
        reached = started[2].wait(TIMEOUT)
        held = not started[3].wait(0.5)
        yielded = gen.total_yielded()
        values = [pkg.rt.get(ref, timeout=TIMEOUT) for ref in gen]
        return reached, held, yielded, values

    assert _same(program) == (True, True, 2, list(builtins.range(6)))


def test_store_pin_unpin_free_and_list_objects_match_jax():
    def program(pkg):
        rt = pkg.rt.core.runtime.get_runtime()
        store = rt.object_store
        ref = pkg.rt.put(np.arange(10))
        oid = ref.object_id
        store.pin(oid)
        store.pin(oid)
        pins = [o["pin_count"] for o in pkg.state.list_objects() if o["object_id"] == oid.hex()]
        store.unpin(oid)
        store.unpin(oid)
        store.unpin(oid)  # never below zero
        after = [o["pin_count"] for o in pkg.state.list_objects() if o["object_id"] == oid.hex()]
        # a pinned value outlives its last handle; unpinning leaves it to free()
        held = pkg.rt.put(np.arange(5))
        hid = held.object_id
        store.pin(hid)
        del held
        alive = store.entry(hid) is not None and store.entry(hid).value is not None
        store.unpin(hid)
        store.free(hid)
        gone = store.entry(hid) is None
        host_before = store.usage()["host_bytes"]
        store.free(oid)
        return pins, after, alive, gone, host_before - store.usage()["host_bytes"]

    assert _same(program) == ([2], [0], True, True, 80)


# -------------------------------------------------------- pools and queues


def test_actor_pool_and_queue_match_jax():
    def program(pkg):
        @pkg.rt.remote
        class Doubler:
            def work(self, x):
                return x * 2

        pool = pkg.ActorPool([Doubler.remote() for _ in range(3)])
        ordered = list(pool.map(lambda a, v: a.work.remote(v), range(10)))
        idle = pool.num_idle
        # one actor: results come back in order in both packages (JAX's
        # pool mis-counts pending results when they do not, see below)
        unordered = sorted(pkg.ActorPool([Doubler.remote()]).map_unordered(
            lambda a, v: a.work.remote(v), range(8)))
        one = pkg.ActorPool([Doubler.remote()])
        one.submit(lambda a, v: a.work.remote(v), 10)
        one.submit(lambda a, v: a.work.remote(v), 20)
        nexts = [one.get_next(), one.get_next(), one.has_next()]

        q = pkg.Queue(maxsize=2)
        q.put(1)
        q.put_nowait({"a": 2})
        full = q.full()
        errors = []
        try:
            q.put(3, block=False)
        except pkg.Full:
            errors.append("full")
        got = [q.get(), q.get_nowait(), q.empty(), q.qsize()]
        try:
            q.get(timeout=0.05)
        except pkg.Empty:
            errors.append("empty")

        @pkg.rt.remote
        def producer(queue):
            for i in range(3):
                queue.put(i * 10)
            return "done"

        ref = producer.remote(q)
        shared = [q.get(timeout=TIMEOUT) for _ in range(3)]
        done = pkg.rt.get(ref, timeout=TIMEOUT)
        q.shutdown()
        return ordered, idle, unordered, nexts, full, errors, got, shared, done

    assert _same(program, num_cpus=8) == (
        [x * 2 for x in range(10)], 3, [x * 2 for x in range(8)], [20, 40, False], True,
        ["full", "empty"], [1, {"a": 2}, True, 0], [0, 10, 20], "done")


def test_port_actor_pool_map_unordered_out_of_order():
    """Results that finish out of order: the first task waits until the
    consumer holds the second's result. The port's pool yields every
    result once and stops (JAX's counts its ordered cursor as pending and
    waits on no refs: ValueError, ROADMAP §C)."""
    ray_tpu_torch.init(num_cpus=4, detect_accelerators=False)
    release = threading.Event()

    @ray_tpu_torch.remote
    class Gate:
        def work(self, x):
            if x == 0:
                assert release.wait(TIMEOUT)
            return x

    pool = TActorPool([Gate.remote(), Gate.remote()])
    results = pool.map_unordered(lambda a, v: a.work.remote(v), [0, 1])
    first = next(results)
    release.set()
    out = [first] + list(results)
    assert out == [1, 0] and not pool.has_next() and pool.num_idle == 2
    pool.submit(lambda a, v: a.work.remote(v), 2)
    assert pool.get_next() == 2


# ---------------------------------------------------------- torch batches


@pytest.mark.parametrize("kw", [
    {},
    {"drop_last": True},
    {"columns": ["tokens"], "dtypes": {"tokens": torch.int64}},
    {"dtypes": {"f": torch.float64}},
])
def test_iter_torch_batches_cpu_match_jax(kw):
    def program(pkg):
        ds = _big(pkg.data)
        if pkg.name == "torch":
            return list(ds.iter_torch_batches(384, device="cpu", **kw))
        return list(ds.iter_torch_batches(384, **kw))

    out = _both(program)
    assert len(out["jax"]) == len(out["torch"])
    for a, b in zip(out["jax"], out["torch"]):
        assert list(a) == list(b) and isinstance(b, dict) and b.ready is None
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].device == b[k].device and torch.equal(a[k], b[k])


def test_split_iterator_torch_batches_drop_last_like_jax_batches():
    """A split's iter_torch_batches defaults to drop_last=True, as JAX's
    iter_jax_batches does: equal step counts on every gang rank."""
    import inspect

    sig = inspect.signature
    assert sig(tdataset.DataIterator.iter_torch_batches).parameters["drop_last"].default is True
    assert sig(jdataset.DataIterator.iter_jax_batches).parameters["drop_last"].default is True
    assert sig(tdataset.Dataset.iter_torch_batches).parameters["drop_last"].default is False

    def program(pkg):
        it = pkg.data.range(103, num_blocks=4).streaming_split(1)[0]
        if pkg.name == "torch":
            return [b["item"].tolist() for b in it.iter_torch_batches(10, device="cpu")]
        return [np.asarray(b["item"]).tolist() for b in it.iter_jax_batches(10)]

    out = _same(program)
    assert len(out) == 10 and all(len(b) == 10 for b in out)


def test_data_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False)
    ds = tdata.from_numpy({"tokens": np.arange(40)}, num_blocks=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.iter_torch_batches(8)
    split = ds.streaming_split(1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        split.iter_torch_batches(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.lm_batch_iterator(split, 3, 2)
    batches = list(tdata.lm_batch_iterator(split, 3, 2, device="cpu"))
    assert len(batches) == 5 and batches[0]["tokens"].tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    split.close()
