"""The port's job manager against the JAX package.

`JobManager`'s lifecycle in both packages on the same entrypoints (submit,
wait, logs, stop, list; the `TypeError`s raised before anything is
registered; a launch failure that lands the job FAILED; a job that sees
its id and imports the package), the job part of
`tests/test_health.py::test_gcs_snapshot_restore_roundtrip` (a job record
survives the GCS snapshot, and one that was RUNNING restores as FAILED),
and `tests/test_dashboard_cli.py::test_cli_job_submit_wait_and_logs`
through `python -m ray_tpu_torch job`.
"""

import os
import subprocess
import sys

import pytest

import ray_tpu.jobs as jjobs
import ray_tpu_torch
import ray_tpu_torch.jobs as tjobs
from ray_tpu_torch.core.config import cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable


def _outcome(mod, tmp_path, name):
    """One drill through a package's JobManager: what each step returned."""
    mgr = mod.JobManager(log_dir=str(tmp_path / name))
    out = {}
    ok = mgr.submit(f"{PY} -c 'import os; print(\"hello\", os.environ[\"RAY_TPU_JOB_ID\"])'",
                    job_id="ok-job", metadata={"team": "x"})
    out["ok"] = (mgr.wait(ok, timeout=60).value, mgr.logs(ok), mgr.info(ok).returncode,
                 mgr.info(ok).metadata)
    bad = mgr.submit(f"{PY} -c 'raise SystemExit(3)'", job_id="bad-job")
    out["bad"] = (mgr.wait(bad, timeout=60).value, mgr.info(bad).returncode)
    sleeper = mgr.submit(f"{PY} -c 'import time; time.sleep(60)'", job_id="sleeper")
    out["running"] = mgr.status(sleeper).value
    out["stop"] = (mgr.stop(sleeper), mgr.wait(sleeper, timeout=30).value)
    out["stop_unknown"] = mgr.stop("never-submitted")
    missing = mgr.submit("/nonexistent/binary --flag", job_id="missing")
    out["missing"] = (mgr.status(missing).value, "failed to launch" in mgr.logs(missing))
    errors = []
    for kwargs in ({"entrypoint": ""}, {"entrypoint": 3}, {"entrypoint": "true", "job_id": 5},
                   {"entrypoint": "true", "env_vars": {"A": 1}}):
        with pytest.raises(TypeError) as exc:
            mgr.submit(**kwargs)
        errors.append(str(exc.value))
    out["type_errors"] = errors
    with pytest.raises(ValueError, match="already exists"):
        mgr.submit("true", job_id="ok-job")
    with pytest.raises(KeyError):
        mgr.status("nope")
    out["list"] = [(j.job_id, j.status.value) for j in mgr.list()]
    return out


def test_job_manager_lifecycle_matches_jax(tmp_path):
    jax_out = _outcome(jjobs, tmp_path, "jax")
    torch_out = _outcome(tjobs, tmp_path, "torch")
    assert torch_out == jax_out
    assert torch_out["ok"] == ("SUCCEEDED", "hello ok-job\n", 0, {"team": "x"})
    assert torch_out["stop"] == (True, "STOPPED") and torch_out["stop_unknown"] is False
    assert torch_out["missing"] == ("FAILED", True)
    assert [s for _, s in torch_out["list"]] == ["SUCCEEDED", "FAILED", "STOPPED", "FAILED"]


def test_job_imports_the_port_from_the_repository_root(tmp_path):
    """PYTHONPATH puts the repository root first, so a job started from
    any directory imports ray_tpu_torch."""
    mgr = tjobs.JobManager(log_dir=str(tmp_path))
    jid = mgr.submit(f"{PY} -c 'import ray_tpu_torch, os; "
                     f"print(os.path.dirname(os.path.dirname(ray_tpu_torch.__file__)))'",
                     working_dir=str(tmp_path))
    assert mgr.wait(jid, timeout=60).value == "SUCCEEDED", mgr.logs(jid)
    assert mgr.logs(jid).strip() == REPO


def test_gcs_snapshot_carries_job_records(tmp_path):
    """A finished job's record survives a snapshot and restore; a job that
    was RUNNING when the snapshot was taken restores as FAILED."""
    snap = str(tmp_path / "gcs.snap")
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False,
                       _system_config={"gcs_snapshot_path": snap,
                                       "gcs_snapshot_interval_s": 0.1})
    mgr = tjobs.default_job_manager()
    try:
        jid = mgr.submit(f"{PY} -c 'print(1)'", job_id="snap-job")
        assert mgr.wait(jid, timeout=30).value == "SUCCEEDED"
        running = mgr.submit(f"{PY} -c 'import time; time.sleep(60)'", job_id="running-job")
        assert mgr.status(running).value == "RUNNING"
        ray_tpu_torch.shutdown()  # the final snapshot: running-job is RUNNING in it
    finally:
        mgr.stop("running-job")
    assert os.path.exists(snap)
    tjobs._default_manager = None  # a new process's manager
    cfg.reset()
    ray_tpu_torch.init(num_cpus=2, detect_accelerators=False,
                       _system_config={"gcs_snapshot_path": snap})
    try:
        restored = tjobs.default_job_manager().info("snap-job")
        assert restored.status.value == "SUCCEEDED"
        assert restored.entrypoint == f"{PY} -c 'print(1)'"
        assert restored.returncode == 0
        assert tjobs.default_job_manager().status("running-job").value == "FAILED"
    finally:
        ray_tpu_torch.shutdown()
        tjobs._default_manager = None
        cfg.reset()


def _run_cli(*args, check=True):
    out = subprocess.run([PY, "-m", "ray_tpu_torch", *args], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    if check:
        assert out.returncode == 0, out.stdout + out.stderr
    return out


def test_cli_job_submit_wait_and_logs():
    out = _run_cli("job", "submit", "python -c 'print(\"hello-from-job\")'",
                   "--job-id", "cli-test-job", "--wait").stdout
    assert "submitted cli-test-job" in out
    assert "hello-from-job" in out
    assert "SUCCEEDED" in out
    failing = _run_cli("job", "submit", "python -c 'raise SystemExit(3)'", "--wait",
                       check=False)
    assert failing.returncode == 1
    assert "FAILED" in failing.stdout
