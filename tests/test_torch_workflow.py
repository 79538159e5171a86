"""The port's Workflow against the JAX package.

A port of `tests/test_workflow.py` on the port's runtime, plus: step ids
of plain arguments equal JAX's (so a storage directory means the same to
both packages, and each package resumes the other's), tensor arguments
digested by dtype, shape and bytes (equal values give equal ids in
another process, any change of value, dtype or shape another id), and a
persisted tensor result that reloads bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.workflow as jworkflow
import ray_tpu_torch
from ray_tpu_torch import workflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def rt():
    runtime = ray_tpu_torch.init(num_cpus=8, detect_accelerators=False)
    yield runtime
    ray_tpu_torch.shutdown()


# ------------------------------------------------------------ step ids


def _source():
    return 10


def _combine(a, b, scale=1):
    return (a + b) * scale


def _dags(mod):
    src = mod.step(_source)
    comb = mod.step(_combine)
    named = mod.step(name="renamed")(_combine)
    s = src.step()
    return [
        s,
        comb.step(1, 2),
        comb.step(1, 2, scale=3),
        comb.step(s, comb.step(s, 2.5), scale="x"),
        comb.step((1, [2, {"k": None}]), b=frozenset({3})),
        named.step(np.arange(4, dtype=np.int32), 7),
        mod.step(max_retries=3, timeout_s=5.0)(_combine).step(1, 2),
        comb.options(max_retries=2).step(1, 2),
    ]


def test_plain_step_ids_match_jax():
    mine = [n.step_id for n in _dags(workflow)]
    ref = [n.step_id for n in _dags(jworkflow)]
    assert mine == ref
    assert len(set(mine)) == len(mine) - 2  # retry / timeout knobs are not hashed


def test_each_package_resumes_the_others_storage(tmp_path):
    """JAX runs the DAG into a storage directory; the port's run of the same
    DAG finds every step done and returns the persisted value, and the
    reverse on a second workflow id."""
    calls = tmp_path / "calls"
    calls.mkdir()

    def counted(x):
        (calls / f"{len(os.listdir(calls))}").touch()
        return x * 3

    ray_tpu.init(num_cpus=2, detect_accelerators=False)
    try:
        assert jworkflow.run(jworkflow.step(counted).step(7), storage=str(tmp_path),
                             workflow_id="j") == 21
        assert workflow.run(workflow.step(counted).step(7), storage=str(tmp_path),
                            workflow_id="j") == 21
        assert workflow.run(workflow.step(counted).step(8), storage=str(tmp_path),
                            workflow_id="t") == 24
        assert jworkflow.run(jworkflow.step(counted).step(8), storage=str(tmp_path),
                             workflow_id="t") == 24
    finally:
        ray_tpu.shutdown()
    assert len(os.listdir(calls)) == 2
    assert workflow.list_completed(str(tmp_path), "j") == \
        jworkflow.list_completed(str(tmp_path), "j")


def _tensor_id(t):
    return workflow.step(_combine).step(t, b=[t, 1]).step_id


_ID_IN_CHILD = (
    "import sys, torch\n"
    "from ray_tpu_torch import workflow\n"
    "sys.path.insert(0, 'tests')\n"
    "from test_torch_workflow import _tensor_id\n"
    "g = torch.Generator().manual_seed(5)\n"
    "print(_tensor_id(torch.randn(3, 5, generator=g).to(torch.bfloat16)))\n"
)


def test_tensor_arguments_digest_by_value_across_processes():
    gen = torch.Generator().manual_seed(5)
    t = torch.randn(3, 5, generator=gen).to(torch.bfloat16)
    sid = _tensor_id(t)
    assert sid == _tensor_id(t.clone()) == _tensor_id(t.t().contiguous().t())
    proc = subprocess.run([sys.executable, "-c", _ID_IN_CHILD], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == sid
    changed = t.clone()
    changed[1, 2] += 1
    others = {_tensor_id(changed), _tensor_id(t.float()), _tensor_id(t.reshape(5, 3)),
              _tensor_id(t[:2])}
    assert sid not in others and len(others) == 4


def test_persisted_tensor_result_reloads_bitwise(tmp_path):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 6, generator=gen, dtype=torch.float32)

    @workflow.step
    def scale(t, k):
        return {"out": t * k, "dtype": str(t.dtype)}

    first = workflow.run(scale.step(x, 1.5), storage=str(tmp_path), workflow_id="w")
    (sid,) = workflow.list_completed(str(tmp_path), "w")
    assert sid.startswith("scale-")

    @workflow.step(name="scale")
    def never(t, k):
        raise AssertionError("a persisted step ran again")

    again = workflow.run(never.step(x.clone(), 1.5), storage=str(tmp_path), workflow_id="w")
    assert torch.equal(first["out"], again["out"]) and again["dtype"] == "torch.float32"
    assert again["out"].device.type == "cpu"


# ------------------------------------------- tests/test_workflow.py, ported


def test_linear_dag(tmp_path):
    @workflow.step
    def add(a, b):
        return a + b

    @workflow.step
    def double(x):
        return 2 * x

    out = double.step(add.step(1, 2))
    assert workflow.run(out, storage=str(tmp_path), workflow_id="lin") == 6


def test_diamond_dag_runs_shared_step_once(tmp_path):
    calls = tmp_path / "calls"
    calls.mkdir()

    @workflow.step
    def source():
        (calls / f"src_{len(os.listdir(calls))}").touch()
        return 10

    @workflow.step
    def left(x):
        return x + 1

    @workflow.step
    def right(x):
        return x + 2

    @workflow.step
    def join(a, b):
        return a * b

    s = source.step()
    out = join.step(left.step(s), right.step(s))
    assert workflow.run(out, storage=str(tmp_path), workflow_id="dia") == 11 * 12
    assert len(os.listdir(calls)) == 1


def test_resume_skips_completed_steps(tmp_path):
    progress = tmp_path / "progress.txt"

    @workflow.step
    def expensive():
        progress.write_text(progress.read_text() + "E" if progress.exists() else "E")
        return 5

    @workflow.step
    def flaky(x):
        if not (tmp_path / "fixed").exists():
            raise RuntimeError("crash on first run")
        return x * 10

    dag = flaky.step(expensive.step())
    with pytest.raises(Exception):
        workflow.run(dag, storage=str(tmp_path), workflow_id="wf")
    assert "E" == progress.read_text()
    assert any(s.startswith("expensive") for s in workflow.list_completed(str(tmp_path), "wf"))

    (tmp_path / "fixed").touch()
    assert workflow.run(dag, storage=str(tmp_path), workflow_id="wf") == 50
    assert "E" == progress.read_text()


def test_different_args_are_different_steps(tmp_path):
    @workflow.step
    def inc(x):
        return x + 1

    assert workflow.run(inc.step(1), storage=str(tmp_path), workflow_id="a") == 2
    assert workflow.run(inc.step(10), storage=str(tmp_path), workflow_id="a") == 11
    completed = workflow.list_completed(str(tmp_path), "a")
    assert len(completed) == 2


def test_flaky_step_retries_then_succeeds(tmp_path):
    attempts = tmp_path / "attempts"

    @workflow.step(max_retries=3)
    def flaky():
        n = int(attempts.read_text()) if attempts.exists() else 0
        attempts.write_text(str(n + 1))
        if n < 2:
            raise RuntimeError(f"boom #{n}")
        return "survived"

    out = workflow.run(
        flaky.step(), storage=str(tmp_path), workflow_id="retry"
    )
    assert out == "survived"
    assert int(attempts.read_text()) == 3
    assert any(
        s.startswith("flaky")
        for s in workflow.list_completed(str(tmp_path), "retry")
    )


def test_retry_budget_exhausted_propagates(tmp_path):
    @workflow.step(max_retries=1)
    def always_fails():
        raise RuntimeError("permanently broken")

    with pytest.raises(Exception, match="permanently broken"):
        workflow.run(
            always_fails.step(), storage=str(tmp_path), workflow_id="budget"
        )
    assert workflow.list_completed(str(tmp_path), "budget") == []


def test_hung_step_times_out(tmp_path):
    import threading
    import time

    release = threading.Event()

    @workflow.step(timeout_s=0.5)
    def hung():
        release.wait(60)
        return 1

    t0 = time.monotonic()
    try:
        with pytest.raises(workflow.WorkflowStepTimeout, match="hung"):
            workflow.run(hung.step(), storage=str(tmp_path), workflow_id="hang")
        assert time.monotonic() - t0 < 30
    finally:
        release.set()  # the task's thread ends before the runtime shuts down


def test_step_options_override(tmp_path):
    calls = tmp_path / "calls"

    @workflow.step
    def sometimes():
        n = int(calls.read_text()) if calls.exists() else 0
        calls.write_text(str(n + 1))
        if n < 1:
            raise RuntimeError("first call fails")
        return "ok"

    node = sometimes.options(max_retries=2).step()
    assert node.max_retries == 2
    assert workflow.run(node, storage=str(tmp_path), workflow_id="opt") == "ok"
