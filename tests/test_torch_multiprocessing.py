"""ray_tpu_torch.util.multiprocessing against ray_tpu's on the CPU.

Counterpart of `tests/test_util_ecosystem.py::test_multiprocessing_pool_map`:
`Pool.map`, `starmap`, `apply`, `map_async` and `imap` over process tasks
give JAX's results, run in worker processes, and refuse work once closed. The
port's Pool refuses a lambda when it is submitted (JAX's cloudpickle
carries it). The functions come from the root module
`torch_process_udfs.py`.
"""

import os

import pytest

import ray_tpu
import ray_tpu_torch
import torch_process_udfs as U
from ray_tpu.util import multiprocessing as jmp
from ray_tpu_torch.util import multiprocessing as tmp

MP = {"jax": (ray_tpu, jmp), "torch": (ray_tpu_torch, tmp)}


@pytest.fixture(autouse=True)
def _nothing_left():
    before = U.live_children()
    yield
    for pkg, _ in MP.values():
        pkg.shutdown()
    assert U.wait_no_children(before) == []


def test_multiprocessing_pool_map():
    out = {}
    for name, (pkg, mp) in MP.items():
        pkg.init(num_cpus=4, detect_accelerators=False)
        with mp.Pool(processes=3) as pool:
            got = (pool.map(U.square, range(8)),
                   pool.starmap(U.add_mul, [(1, 2), (3, 4)]),
                   pool.apply(U.square, (9,)),
                   pool.map_async(U.square, [2, 3]).get(timeout=60),
                   list(pool.imap(U.square, range(5))))
            ready = pool.map_async(U.square, [4])
            ready.wait(timeout=60)
            pids = pool.map(U.getpid, range(3))
        with pytest.raises(ValueError, match="closed"):
            pool.map(U.square, [1])
        out[name] = got, ready.ready(), all(p != os.getpid() for p in pids)
        pkg.shutdown()
    assert out["jax"] == out["torch"] == (
        ([x * x for x in range(8)], [(3, 2), (7, 12)], 81, [4, 9], [0, 1, 4, 9, 16]),
        True, True)


def test_pool_refuses_a_lambda_when_submitted():
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False)
    with tmp.Pool(processes=2) as pool:
        with pytest.raises(TypeError, match="module level"):
            pool.apply(lambda: 1)
        assert pool.map(U.square, [3]) == [9]
    ray_tpu.init(num_cpus=2, detect_accelerators=False)
    with jmp.Pool(processes=2) as pool:
        assert pool.apply(lambda: 1) == 1
