"""ray_tpu_torch's process executors against ray_tpu's on the CPU.

Counterpart of `tests/test_worker_pool.py`'s pool and task cases: the
pool on its own (reuse, env isolation, a crash, eviction when full,
prestarting) and process tasks through the runtime (pids, errors,
retries after a crash); its actor and runtime-env cases are in
`tests/test_torch_process_actors.py`. Each runtime test runs
one program through both packages (`_both`) and compares values, error
types and counts exactly. The functions and classes the workers run live
in the root module `torch_process_udfs.py`: the port sends them by
reference with the standard pickle, and a JAX worker imports that module
without torch. What only the port has: the submission-time refusal of
what a worker could not import (a lambda, which JAX's cloudpickle
carries), and the rule that no CUDA tensor crosses a worker's pipe,
checked on a CPU build with a tensor that reports `is_cuda`: the frame
is refused before anything is sent.

No timing assertions: every wait is a result, a pid or a restart, bounded
by a timeout. The fixture shuts both runtimes down and asserts that no
worker process and no health, monitor or reaper thread is left.
"""

import os
import threading

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
import torch_process_udfs as U
from ray_tpu.core import worker_pool as jpool
from ray_tpu_torch.core import worker_pool as tpool
from ray_tpu_torch.core.config import cfg as tcfg

PKGS = {"jax": ray_tpu, "torch": ray_tpu_torch}
POOLS = {"jax": jpool, "torch": tpool}
TIMEOUT = 60
_THREADS = ("health-check", "memory-monitor", "worker-reaper")


def _both(program, **init):
    """Run `program(name, pkg)` under each package's runtime; returns
    {name: outcome}."""
    out = {}
    for name, pkg in PKGS.items():
        pkg.init(**{"num_cpus": 4, "detect_accelerators": False, **init})
        try:
            out[name] = program(name, pkg)
        finally:
            pkg.shutdown()
    return out


def _same(program, **init):
    out = _both(program, **init)
    assert out["jax"] == out["torch"], out
    return out["torch"]


@pytest.fixture(autouse=True)
def _nothing_left():
    before = U.live_children()
    yield
    for pkg in PKGS.values():
        pkg.shutdown()
    tcfg.reset()
    assert U.wait_no_children(before) == []
    assert tpool.peek_worker_pool() is None
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch") and t.name.endswith(_THREADS)]
    assert left == []


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself on a CUDA device."""

    @property
    def is_cuda(self):
        return True


def _cause_types(exc):
    out = []
    while exc is not None and len(out) < 6:
        out.append(type(exc).__name__)
        exc = getattr(exc, "cause", None)
    return out


# ------------------------------------------------------------------ pool unit


def test_pool_executes_and_reuses_workers():
    out = {}
    for name, mod in POOLS.items():
        pool = mod.ProcessWorkerPool(max_workers=2)
        try:
            sq = pool.execute(U.square, (7,), {})
            pid1 = pool.execute(U.getpid, (), {})
            pid2 = pool.execute(U.getpid, (), {})
            out[name] = (sq, pid1 == pid2, pid1 != os.getpid(), dict(pool.stats))
        finally:
            pool.shutdown()
    assert out["jax"] == out["torch"] == (
        49, True, True, {"spawned": 1, "reused": 2, "reaped": 0, "crashed": 0})


def test_pool_env_isolation():
    out = {}
    for name, mod in POOLS.items():
        pool = mod.ProcessWorkerPool(max_workers=2)
        try:
            inside = pool.execute(U.read_env, ("RAY_TPU_TEST_ENV",), {},
                                  env_vars={"RAY_TPU_TEST_ENV": "inside"})
            plain = pool.execute(U.read_env, ("RAY_TPU_TEST_ENV",), {})
            out[name] = (inside, plain, os.environ.get("RAY_TPU_TEST_ENV"), pool.num_workers())
        finally:
            pool.shutdown()
    assert out["jax"] == out["torch"] == ("inside", None, None, 2)


def test_pool_worker_crash_raises_and_recovers():
    out = {}
    for name, mod in POOLS.items():
        pool = mod.ProcessWorkerPool(max_workers=2)
        try:
            with pytest.raises(mod.WorkerCrashedError) as info:
                pool.execute(U.crash, (), {})
            out[name] = (isinstance(info.value, Exception), pool.execute(U.square, (3,), {}),
                         pool.stats["crashed"], pool.stats["spawned"])
        finally:
            pool.shutdown()
    assert out["jax"] == out["torch"] == (True, 9, 1, 2)


def test_pool_full_evicts_an_idle_worker_of_another_env():
    out = {}
    for name, mod in POOLS.items():
        pool = mod.ProcessWorkerPool(max_workers=1)
        try:
            a = pool.execute(U.read_env, ("E",), {}, env_vars={"E": "a"})
            b = pool.execute(U.read_env, ("E",), {}, env_vars={"E": "b"})
            out[name] = (a, b, pool.num_workers(), pool.stats["spawned"])
        finally:
            pool.shutdown()
    assert out["jax"] == out["torch"] == ("a", "b", 1, 2)


def test_pool_prestart_starts_idle_workers_that_tasks_reuse():
    pool = tpool.ProcessWorkerPool(max_workers=3)
    try:
        pids = pool.prestart(2)
        assert len(set(pids)) == 2 and os.getpid() not in pids
        assert pool.prestart(2) == pids  # already there: nothing started
        assert pool.execute(U.getpid, (), {}) in pids
        assert pool.stats["spawned"] == 2 and pool.stats["reused"] == 1
        assert sorted(pool.pids()) == sorted(pids)
    finally:
        pool.shutdown()


def test_cuda_tensor_refused_before_the_pipe():
    fake = torch.zeros(3).as_subclass(_FakeCuda)
    worker = tpool.WorkerProcess()
    sent = []
    real_send = worker._conn.send
    worker._conn.send = lambda frame: (sent.append(frame[0]), real_send(frame))
    try:
        with pytest.raises(TypeError, match=r"\.cpu\(\)"):
            worker.request("task", (U.square, (fake,), {}))
        assert sent == []  # refused while pickling: nothing reached the pipe
        # the pipe is still in step: the next frame gets its own reply
        assert worker.request("task", (U.square, (np.arange(3),), {})).tolist() == [0, 1, 4]
        assert sent == ["task"]
        # a CPU tensor crosses
        assert worker.request("task", (U.square, (torch.arange(3),), {})).tolist() == [0, 1, 4]
    finally:
        worker.shutdown()


# ------------------------------------------------------------- task executor


def test_process_task_runs_in_separate_pid():
    def program(name, pkg):
        child = pkg.get(pkg.remote(U.getpid).options(executor="process").remote(),
                        timeout=TIMEOUT)
        return child != os.getpid()

    assert _same(program) is True


def test_process_task_error_propagates():
    def program(name, pkg):
        with pytest.raises(Exception) as info:
            pkg.get(pkg.remote(U.boom).options(executor="process").remote("process boom"),
                    timeout=TIMEOUT)
        return _cause_types(info.value), "process boom" in str(info.value)

    assert _same(program) == (["TaskError", "ValueError"], True)


def test_process_task_crash_retries(tmp_path):
    def program(name, pkg):
        f = pkg.remote(U.crash_once).options(executor="process", max_retries=2,
                                             retry_exceptions=True)
        value = pkg.get(f.remote(str(tmp_path / name)), timeout=TIMEOUT)
        rt = pkg.core.runtime.get_runtime()
        return value, rt.scheduler.stats["retries"]

    assert _same(program) == ("recovered", 1)


def test_process_task_crash_without_retries_fails_with_worker_crashed():
    def program(name, pkg):
        with pytest.raises(Exception) as info:
            pkg.get(pkg.remote(U.crash).options(executor="process").remote(), timeout=TIMEOUT)
        return _cause_types(info.value)

    assert _same(program) == ["TaskError", "WorkerCrashedError"]


def test_streaming_process_task_is_refused():
    def program(name, pkg):
        with pytest.raises(ValueError, match="streaming") as info:
            pkg.remote(U.square).options(executor="process", num_returns="streaming").remote(2)
        return str(info.value)

    _same(program)


def test_lambda_refused_at_submission_not_in_the_child():
    def program(name, pkg):
        f = pkg.remote(lambda: 1).options(executor="process")
        if name == "jax":  # cloudpickle carries the lambda by value
            return pkg.get(f.remote(), timeout=TIMEOUT)
        with pytest.raises(TypeError, match="module level") as info:
            f.remote()
        return "lambda" in str(info.value), tpool.peek_worker_pool() is None

    out = _both(program)
    assert out == {"jax": 1, "torch": (True, True)}  # no worker was started


def test_process_task_cuda_tensor_arg_fails_with_the_rule():
    fake = torch.zeros(3).as_subclass(_FakeCuda)
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False)
    with pytest.raises(ray_tpu_torch.TaskError) as info:
        ray_tpu_torch.get(ray_tpu_torch.remote(U.square).options(executor="process")
                          .remote(fake), timeout=TIMEOUT)
    assert isinstance(info.value.cause, TypeError) and ".cpu()" in str(info.value.cause)
