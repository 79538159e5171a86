"""The port's dashboard and CLI against the JAX package.

A port of `tests/test_dashboard_cli.py` (its `test_cli_job_submit_wait_and_
logs` is in `tests/test_torch_jobs.py`), plus: every JSON endpoint of
JAX's dashboard answers in the port's with the same top-level shape, the
node-telemetry table reads the `cuda` stats block, the CLI's subcommands
all run (`doctor` with `--no-cuda` here; without it the commands that
start their own runtime raise where there is no card), and a runtime
already up in the calling process outlives a command.
The dashboard binds port 0, so parallel test workers never collide.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest
import torch

import ray_tpu
import ray_tpu.dashboard as jdash
import ray_tpu_torch
from ray_tpu_torch.dashboard import _PAGE, start_dashboard, stop_dashboard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cluster():
    ray_tpu_torch.init(num_cpus=4, detect_accelerators=False)
    yield
    stop_dashboard()
    ray_tpu_torch.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _run_cli(*args, check=True):
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", *args],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    if check:
        assert proc.returncode == 0, proc.stderr
    return proc


# ------------------------------------------------------- parity with JAX's


JSON_ENDPOINTS = ("summary", "nodes", "node_stats", "cluster_metrics", "autoscaler", "head",
                  "status", "actors", "tasks", "objects", "timeline", "traces", "profiles",
                  "events", "cluster_events", "requests", "steps", "engines", "goodput", "logs",
                  "jobs")


def _shapes(url):
    out = {}
    for name in JSON_ENDPOINTS:
        status, body = _get(f"{url}/api/{name}")
        value = json.loads(body)
        out[name] = (status, type(value).__name__,
                     sorted(value) if name in ("summary", "status") else None)
    return out


def test_every_endpoint_answers_with_jax_shapes():
    @ray_tpu_torch.remote
    def work(x):
        return x + 1

    assert ray_tpu_torch.get(work.remote(1)) == 2
    mine = _shapes(start_dashboard(port=0))
    ray_tpu.init(num_cpus=2, detect_accelerators=False)
    try:
        ref = _shapes(jdash.start_dashboard(port=0))
    finally:
        jdash.stop_dashboard()
        ray_tpu.shutdown()
    assert mine == ref


def test_telemetry_table_reads_the_cuda_block():
    """The page's node-telemetry row sums each node's `cuda` devices'
    allocated and reserved bytes (JAX's counted its `tpu` devices)."""
    assert "(t.cuda || [])" in _PAGE and "memory_allocated_bytes" in _PAGE
    assert "memory_reserved_bytes" in _PAGE and "t.tpu" not in _PAGE
    url = start_dashboard(port=0)
    stats = json.loads(_get(url + "/api/node_stats")[1])
    assert stats and all(isinstance(s["cuda"], list) for s in stats.values())
    if not torch.cuda.is_initialized():
        assert all(s["cuda"] == [] for s in stats.values())


def test_cli_without_a_card_raises_unless_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    for cmd in ("doctor", "status", "dashboard"):
        proc = _run_cli(cmd, check=False)
        assert proc.returncode != 0 and "pass --no-cuda" in proc.stderr, cmd
    out = _run_cli("--no-cuda", "doctor").stdout
    assert f"torch: {torch.__version__}" in out and "task round-trip: ok" in out
    assert "'CPU'" in out and "GPU" not in out


def test_cli_leaves_a_runtime_it_did_not_start(capsys, tmp_path):
    """In process, a command inspects the runtime already up and leaves
    it running (JAX's shut it down)."""
    from ray_tpu_torch.cli import main

    assert main(["status", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["nodes"] == 1
    assert main(["postmortem", "--output", str(tmp_path / "pm.tgz")]) == 0
    assert "wrote" in capsys.readouterr().out and (tmp_path / "pm.tgz").exists()
    assert main(["timeline", str(tmp_path / "tl.json")]) == 0
    assert "traceEvents" in json.loads((tmp_path / "tl.json").read_text())
    assert ray_tpu_torch.is_initialized()
    assert ray_tpu_torch.get(ray_tpu_torch.put(5)) == 5


def test_cli_profile_captures_host_profile(tmp_path):
    out = _run_cli("--no-cuda", "profile", "--duration", "0.5", "--no-device",
                   "--output", str(tmp_path)).stdout
    assert "profile " in out and "1 node(s)" in out and "wrote " in out


# --------------------------------------- tests/test_dashboard_cli.py, ported


def test_dashboard_serves_state_and_page():
    @ray_tpu_torch.remote
    def work(x):
        return x + 1

    assert ray_tpu_torch.get(work.remote(1)) == 2

    @ray_tpu_torch.remote
    class A:
        def noop(self):
            return None

    a = A.options(name="dash-actor").remote()
    ray_tpu_torch.get(a.noop.remote())

    url = start_dashboard(port=0)
    status, page = _get(url + "/")
    assert status == 200 and "ray_tpu_torch dashboard" in page

    status, body = _get(url + "/api/summary")
    summary = json.loads(body)
    assert summary["nodes"] == 1
    assert summary["tasks_finished"] >= 1

    status, body = _get(url + "/api/actors")
    actors = json.loads(body)
    assert any(x["name"] == "dash-actor" for x in actors)

    status, body = _get(url + "/api/tasks")
    assert any(t["name"] == "work" for t in json.loads(body))

    status, body = _get(url + "/api/timeline")
    assert "traceEvents" in json.loads(body)

    status, body = _get(url + "/metrics")
    assert status == 200

    with pytest.raises(Exception):
        _get(url + "/api/nonsense")


def test_cli_config_lists_flags():
    out = _run_cli("config").stdout
    assert "object_store_capacity_bytes" in out
    assert "RAY_TPU_NATIVE_STORE" in out


def test_cli_status():
    out = _run_cli("--no-cuda", "status").stdout
    assert "Nodes: 1 (1 ALIVE)" in out
    assert "object store:" in out and "worker pool:" in out
    out = _run_cli("--no-cuda", "status", "--json").stdout
    assert '"nodes": 1' in out
    assert '"node_stats"' in out


def test_rest_job_submission():
    """POST /api/jobs submits a real subprocess job."""
    from ray_tpu_torch.jobs import default_job_manager

    url = start_dashboard(port=0)
    req = urllib.request.Request(
        url + "/api/jobs",
        data=json.dumps({
            "entrypoint": "python -c 'print(40+2)'",
            "job_id": "rest-job-1",
        }).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read())["job_id"] == "rest-job-1"
    mgr = default_job_manager()
    assert mgr.wait("rest-job-1", timeout=60).value == "SUCCEEDED"
    assert "42" in mgr.logs("rest-job-1")
    status, body = _get(url + "/api/jobs")
    assert any(j["job_id"] == "rest-job-1" for j in json.loads(body))
    bad = urllib.request.Request(
        url + "/api/jobs",
        data=json.dumps({"entrypoint": ["not", "a", "string"]}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        urllib.request.urlopen(bad, timeout=10)
        raise AssertionError("expected HTTP 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400
    assert all(j.entrypoint != ["not", "a", "string"] for j in mgr.list())
    form = urllib.request.Request(
        url + "/api/jobs",
        data=json.dumps({"entrypoint": "python -c 'print(1)'"}).encode(),
        headers={"Content-Type": "application/x-www-form-urlencoded"},
    )
    try:
        urllib.request.urlopen(form, timeout=10)
        raise AssertionError("expected HTTP 415")
    except urllib.error.HTTPError as e:
        assert e.code == 415


def test_rest_failure_paths():
    """Malformed bodies, wrong content types, unknown endpoints, and
    dead-job lookups all answer with errors instead of crashing the
    server or fabricating state."""
    from ray_tpu_torch.jobs import default_job_manager

    url = start_dashboard(port=0)

    def post(data: bytes, ctype="application/json"):
        req = urllib.request.Request(
            url + "/api/jobs", data=data, headers={"Content-Type": ctype}
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    assert post(b"this is not json") == 400
    assert post(json.dumps({"no_entrypoint": True}).encode()) == 400
    assert post(json.dumps({"entrypoint": "echo hi"}).encode(),
                ctype="text/plain") == 415  # CSRF guard
    assert post(json.dumps({"entrypoint": ""}).encode()) == 400
    assert all(
        j.job_id != "phantom" for j in default_job_manager().list()
    )

    def get_code(path):
        try:
            with urllib.request.urlopen(url + path, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    status, body = get_code("/api/nonsense")
    assert status == 500
    assert "unknown endpoint" in body

    status, _ = get_code("/definitely/not/here")
    assert status == 404


def test_dead_job_lookups():
    """status/logs/wait of a job id that never existed raise KeyError."""
    from ray_tpu_torch.jobs import default_job_manager

    mgr = default_job_manager()
    with pytest.raises(KeyError):
        mgr.status("never-existed")
    with pytest.raises(KeyError):
        mgr.logs("never-existed")
    with pytest.raises(KeyError):
        mgr.wait("never-existed", timeout=1)
