"""ray_tpu_torch's native arena and SHM tier against ray_tpu's on the CPU.

Counterpart of `tests/test_native_store.py`: each arena case runs on both
packages' `NativeArena` (the same `native/objstore.cc`, built by each
package into its own directory: the port's into
`ray_tpu_torch/core/_native/`), and one sequence of puts, pins, deletes
and evictions gives the same offsets and the same eviction order in
both. The store cases hold the port's SHM tier against JAX's: tiers,
`shm_puts` / `shm_evictions`, values after spilling, and what a process
worker sees of an SHM argument (a read-only view of the arena, not a
pickled copy). Beyond JAX: a Data block (a dict of arrays) enters the
port's arena as one object and reaches a process worker as read-only
views; the arena is capped at its directory's free bytes, dead
processes' arena files are removed, and a store asked for the tier has
a live arena whenever the library builds (the card phase fails on
`shm_puts == 0`, so a failed build cannot pass as a success).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
import torch_process_udfs as U
from ray_tpu.core import native_store as jnative
from ray_tpu.core import object_store as jstore_mod
from ray_tpu.core.config import cfg as jcfg
from ray_tpu.core.ids import JobID as JJobID, ObjectID as JObjectID, TaskID as JTaskID
from ray_tpu_torch.core import native_store as tnative
from ray_tpu_torch.core import object_store as tstore_mod
from ray_tpu_torch.core.config import cfg as tcfg
from ray_tpu_torch.core.ids import JobID as TJobID, ObjectID as TObjectID, TaskID as TTaskID

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARENAS = {"jax": jnative, "torch": tnative}
STORES = {
    "jax": (jstore_mod, jcfg, JJobID, JObjectID, JTaskID),
    "torch": (tstore_mod, tcfg, TJobID, TObjectID, TTaskID),
}


@pytest.fixture(autouse=True)
def _clean():
    before = U.live_children()
    yield
    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.shutdown()
    jcfg.reset()
    tcfg.reset()
    assert U.wait_no_children(before) == []


def test_native_library_builds_into_the_ports_directory():
    assert tnative.native_available(), tnative.build_error()
    assert tnative._LIB_PATH == os.path.join(REPO, "ray_tpu_torch", "core", "_native",
                                             "libobjstore.so")
    assert os.path.exists(tnative._LIB_PATH)
    assert tnative._abi_matches(tnative._LIB_PATH)


@pytest.fixture(params=["jax", "torch"])
def arena(request):
    mod = ARENAS[request.param]
    if not mod.native_available():
        pytest.skip(f"{request.param}: native objstore not built")
    a = mod.NativeArena(1 << 20)
    yield a
    a.close()


def test_put_get_roundtrip(arena):
    data = b"hello world" * 100
    assert arena.put(1, data)
    assert bytes(arena.get(1)) == data
    arena.unpin(1)
    assert arena.num_objects == 1


def test_numpy_zero_copy(arena):
    x = np.arange(1000, dtype=np.float32)
    assert arena.put(2, x.tobytes())
    np.testing.assert_array_equal(x, np.frombuffer(arena.get(2), dtype=np.float32))
    arena.unpin(2)


def test_delete_frees_and_coalesces(arena):
    for i in range(8):
        assert arena.put(i, bytes(1000))
    assert arena.used > 0
    for i in range(8):
        assert arena.delete(i)
    assert arena.used == 0 and arena.num_free_blocks == 1


def test_full_arena_rejects(arena):
    assert arena.put(1, bytes((1 << 20) - 64))
    assert not arena.put(2, bytes(1024))


def test_pinned_objects_not_evictable(arena):
    assert arena.put(1, bytes(512 << 10))
    view = arena.get(1)  # pinned
    assert arena.lru_candidate() is None
    assert not arena.delete(1)
    arena.unpin(1)
    assert arena.lru_candidate() == 1 and arena.delete(1)
    del view


def test_duplicate_id_rejected(arena):
    assert arena.put(7, b"x")
    assert arena.put(7, b"y") is False


def test_many_small_objects_fragmentation(arena):
    for round_ in range(5):
        ids = list(range(round_ * 100, round_ * 100 + 100))
        for i in ids:
            assert arena.put(i, bytes(int(np.random.default_rng(i).integers(100, 2000))))
        for i in ids[::2]:
            assert arena.delete(i)
        for i in ids[1::2]:
            assert arena.get(i) is not None
            arena.unpin(i)
            assert arena.delete(i)
    assert arena.num_objects == 0 and arena.used == 0 and arena.num_free_blocks == 1


def _arena_program(mod, path):
    """One sequence of puts, pins, deletes and evictions on a shared arena:
    every descriptor's offset, the LRU candidates and the eviction order."""
    rng = np.random.default_rng(7)
    a = mod.NativeArena(1 << 20, path=path)
    log = []
    try:
        sizes = rng.integers(1 << 10, 96 << 10, 24)
        for i, n in enumerate(sizes[:12]):
            log.append(("put", i, a.put(i, bytes(int(n)))))
        for i in (3, 5, 9):
            view = a.get(i)  # touch: moves to the LRU's young end, pinned
            a.unpin(i)
            del view
        log.append(("pinned", a.descriptor(4)[1:]))  # pinned until released
        for i in (0, 2, 7):
            log.append(("delete", i, a.delete(i)))
        evicted = []
        for i, n in enumerate(sizes[12:], start=100):
            ok = a.put_with_eviction(i, bytes(int(n) * 4),
                                     on_evict=lambda v, _view: evicted.append(v))
            log.append(("evict-put", i, ok))
        a.release_descriptor(4)
        log.append(("evicted", evicted))
        log.append(("lru", a.lru_candidate()))
        live = sorted(i for i in list(range(12)) + list(range(100, 112))
                      if a.descriptor(i) is not None)
        log.append(("offsets", [(i, a.descriptor(i)[1:]) for i in live]))
        for i in live:
            a.release_descriptor(i)
        log.append(("stats", a.used, a.num_objects, a.num_free_blocks, a.capacity))
    finally:
        a.close()
    return log


def test_arena_offsets_and_eviction_order_match_jax(tmp_path):
    if not jnative.native_available():
        pytest.skip("jax: native objstore not built")
    jlog = _arena_program(jnative, str(tmp_path / "j_arena"))
    tlog = _arena_program(tnative, str(tmp_path / "t_arena"))
    assert jlog == tlog
    assert dict((e[0], e[1]) for e in jlog if e[0] == "evicted")["evicted"]  # evictions ran


# ------------------------------------------------------- ObjectStore SHM tier


def _store(name, capacity, spill_dir=None, shm_min=None):
    mod, cfg, *_ = STORES[name]
    cfg.set(native_store=True, **({"shm_min_bytes": shm_min} if shm_min else {}))
    try:
        return mod.ObjectStore(capacity_bytes=capacity, spill_dir=spill_dir)
    finally:
        cfg.reset()


def _oids(name, n):
    _, _, job, oid, task = STORES[name]
    t = task.of(job.next())
    return [oid.for_task_return(t, i) for i in range(n)]


def test_object_store_shm_tier_roundtrip(tmp_path):
    out = {}
    for name in STORES:
        store = _store(name, 4 << 20, str(tmp_path / name))
        assert store._arena is not None
        (oid,) = _oids(name, 1)
        arr = np.arange(100_000, dtype=np.float32)
        store.put(oid, arr)
        tier = store.entry(oid).tier.value
        got = store.get(oid)
        np.testing.assert_array_equal(got, arr)
        store.free(oid)
        out[name] = tier, store.stats["shm_puts"], store._arena.num_objects, got.flags.writeable
        store._arena.close()
    assert out["jax"] == out["torch"] == ("shm", 1, 0, True)


def test_object_store_shm_eviction_spills_to_disk(tmp_path):
    out = {}
    for name in STORES:
        store = _store(name, 1 << 20, str(tmp_path / name))
        oids = _oids(name, 4)
        arrays = [np.full(100_000, i, dtype=np.float32) for i in range(4)]
        for oid, arr in zip(oids, arrays):
            store.put(oid, arr)
        tiers = [store.entry(o).tier.value for o in oids]
        for oid, arr in zip(oids, arrays):
            np.testing.assert_array_equal(store.get(oid), arr)
        out[name] = tiers, store.stats["shm_evictions"], store.stats["spills"]
        store._arena.close()
    assert out["jax"] == out["torch"]
    assert out["torch"][1] >= 2


def test_small_and_object_dtype_bypass_shm():
    out = {}
    for name in STORES:
        store = _store(name, 1 << 20)
        o1, o2, o3 = _oids(name, 3)
        store.put(o1, np.arange(10))
        store.put(o2, "not an array")
        store.put(o3, np.array([object()] * 20_000, dtype=object))
        out[name] = [store.entry(o).tier.value for o in (o1, o2, o3)], store.stats["shm_puts"]
        store._arena.close()
    assert out["jax"] == out["torch"] == (["inline", "inline", "host"], 0)


def test_port_data_block_enters_the_arena_as_one_object():
    """Beyond JAX (whose arena takes bare arrays only, so a block stays a
    HOST value there): the block's arrays are packed into one arena
    object and come back equal, as copies."""
    store = _store("torch", 4 << 20, shm_min=1024)
    oid, obj_oid = _oids("torch", 2)
    block = {"x": np.arange(3000, dtype=np.int64), "y": np.ones((1000, 3), np.float16),
             "z": np.zeros(0, np.int32)}
    store.put(oid, block)
    got = store.get(oid)
    assert store.entry(oid).tier.value == "shm" and store._arena.num_objects == 1
    assert store.entry(oid).nbytes == sum(v.nbytes for v in block.values())
    for k, v in block.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and got[k].flags.writeable
        np.testing.assert_array_equal(got[k], v)
    store.put(obj_oid, {"s": np.array(["a"] * 5000, dtype=object)})
    assert store.entry(obj_oid).tier.value != "shm"  # object dtype stays off the arena
    store.free(oid)
    assert store._arena.num_objects == 0
    store.close_arena()


def test_arena_is_live_whenever_the_library_builds():
    store = _store("torch", 1 << 20)
    assert tnative.native_available()
    assert store.arena is not None and store.arena_error is None
    assert os.path.basename(store.arena.path).startswith(tstore_mod.ARENA_PREFIX)
    path = store.arena.path
    store.close_arena()
    assert store.arena is None and not os.path.exists(path)


def test_arena_capped_at_free_bytes(monkeypatch):
    monkeypatch.setattr(tstore_mod, "free_bytes", lambda directory: 3 << 20)
    store = _store("torch", 64 << 20)
    assert store.arena.capacity == 3 << 20
    store.close_arena()


def test_closed_arena_loses_its_objects():
    store = _store("torch", 1 << 20)
    (oid,) = _oids("torch", 1)
    store.put(oid, np.arange(100_000, dtype=np.float32))
    store.close_arena()
    with pytest.raises(ray_tpu_torch.ObjectLostError):
        store.get(oid)
    store.free(oid)  # releasing it after the close touches no arena


def test_stale_arena_files_of_dead_processes_are_removed(tmp_path):
    proc = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    dead = tmp_path / f"{tstore_mod.ARENA_PREFIX}{int(proc.stdout)}_deadbeef"
    live = tmp_path / f"{tstore_mod.ARENA_PREFIX}{os.getpid()}_cafef00d"
    other = tmp_path / "unrelated_file"
    for p in (dead, live, other):
        p.write_bytes(b"\0" * 16)
    tstore_mod._reap_stale_arenas(str(tmp_path))
    assert not dead.exists() and live.exists() and other.exists()


def test_shared_arena_cross_process_descriptor(tmp_path):
    """A second OS process maps the arena file and reads a sealed payload
    zero-copy through its (offset, size) descriptor."""
    path = str(tmp_path / "arena")
    arena = tnative.NativeArena(1 << 20, path=path)
    arr = np.arange(5000, dtype=np.float64)
    assert arena.put(42, arr.tobytes())
    _, offset, size = arena.descriptor(42)
    view = tnative.ShmView(path, offset, size // 8, "float64", (5000,))
    script = ("import pickle, sys\n"
              "v = pickle.load(sys.stdin.buffer)\n"
              "assert not v.flags.writeable\n"
              "print(float(v.sum()), float(v[4321]))\n")
    out = subprocess.run([sys.executable, "-c", script], input=pickle.dumps(view),
                         capture_output=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO)
    assert out.returncode == 0, out.stderr.decode()
    total, probe = out.stdout.decode().split()
    assert float(total) == float(arr.sum()) and float(probe) == 4321.0
    arena.release_descriptor(42)
    arena.close()


def test_process_task_gets_zero_copy_shm_arg():
    """An SHM-tier array passed to a process task arrives as a read-only
    view of the arena in both packages; the pin is released after."""
    out = {}
    for name, pkg in (("jax", ray_tpu), ("torch", ray_tpu_torch)):
        pkg.init(num_cpus=2, detect_accelerators=False,
                 _system_config={"native_store": True, "shm_min_bytes": 1024})
        try:
            big = pkg.put(np.arange(200_000, dtype=np.float64))
            info = pkg.get(pkg.remote(U.array_view_info).options(executor="process")
                           .remote(big), timeout=120)
            store = pkg.core.runtime.get_runtime().object_store
            entry = store.entry(big.object_id)
            out[name] = info, entry.tier.value, store.stats["shm_puts"]
        finally:
            pkg.shutdown()
    total = float(np.arange(200_000, dtype=np.float64).sum())
    assert out["jax"] == out["torch"] == ((total, (200_000,), False, True), "shm", 1)


def test_port_process_task_gets_a_block_as_arena_views():
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False,
                       _system_config={"native_store": True, "shm_min_bytes": 1024})
    block = {"a": np.arange(50_000, dtype=np.int32), "b": np.full(2000, 0.5)}
    ref = ray_tpu_torch.put(block)
    got = ray_tpu_torch.get(ray_tpu_torch.remote(U.block_view_info).options(executor="process")
                            .remote(ref), timeout=120)
    assert got == {"a": (float(block["a"].sum()), False), "b": (1000.0, False)}
    store = ray_tpu_torch.core.runtime.get_runtime().object_store
    assert store.entry(ref.object_id).tier.value == "shm"
    # the worker's pins were released: the block can be evicted and deleted
    store.free(ref.object_id)
    assert store.arena.num_objects == 0
