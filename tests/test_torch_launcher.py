"""The port's cluster launcher: the cases of `tests/test_launcher.py` run on
the port (`up` / `down` with the local provider, the ssh provider's
command line, an unknown provider, the CLI round trip, and the ssh
provider's whole lifecycle through a loopback fake `ssh`), and the pattern
`down` kills by: it matches this package's `start` command lines with the
launch tag and never a JAX `python -m ray_tpu start` one. The local case
also runs `chip_smoke.py`'s capacity (d) on the CPU: a worker configured
with `num_gpus` 1 advertises it (and the other none), and a job
(`torch_capacity_job.py --device cpu`) joins the launched cluster and runs
its `num_gpus=1` task there, the flash forward's plain version.

Launched nodes get `RAY_TPU_PREEMPT_WARNING_S=0.5` from the environment:
SIGTERM is a preemption notice to a node, which drains for that long
before it leaves.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
from ray_tpu_torch.jobs import JobManager
from ray_tpu_torch.launcher import (ClusterLauncher, SSHLaunchProvider, _start_cmd,
                                    _state_path, down_pattern, load_config)

FAST_DRAIN = {"RAY_TPU_PREEMPT_WARNING_S": "0.5"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tagged_pids(tag: str):
    """Pids of live processes whose command line `down` would kill."""
    pattern = re.compile(down_pattern(tag))
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                line = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            with open(f"/proc/{entry}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and pattern.search(line):
            out.append(int(entry))
    return out


def _wait_gone(tag: str, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while _tagged_pids(tag) and time.monotonic() < deadline:
        time.sleep(0.2)
    return _tagged_pids(tag)


def test_up_launches_and_down_terminates(tmp_path, monkeypatch):
    import yaml

    for k, v in FAST_DRAIN.items():
        monkeypatch.setenv(k, v)
    port = _free_port()
    config = {
        "head": {"port": port, "num_cpus": 1},
        "workers": [{"host": "localhost", "num_cpus": 2, "resources": {"pet": 1}, "num_gpus": 1},
                    {"host": "localhost", "num_cpus": 2, "resources": {"pet": 1}}],
        "provider": "local",
    }
    path = tmp_path / "cluster.yaml"
    path.write_text(yaml.safe_dump(config))
    launcher = ClusterLauncher(load_config(str(path)))
    try:
        info = launcher.up(wait_s=90)
        assert info["address"].endswith(f":{port}")
        assert len(info["nodes"]) == 3
        ray_tpu_torch.init(address=info["address"], num_cpus=0, detect_accelerators=False)
        deadline = time.monotonic() + 60
        while ray_tpu_torch.cluster_resources().get("pet", 0) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.2)
        # one GPU in the cluster: the worker configured with one
        assert ray_tpu_torch.cluster_resources().get("GPU", 0.0) == 1.0
        where = ray_tpu_torch.remote(num_cpus=0, resources={"pet": 1})(udfs.pid)
        pid = ray_tpu_torch.get(where.remote(), timeout=60)
        assert pid in [n["pid"] for n in info["nodes"]]
        ray_tpu_torch.shutdown()
        mgr = JobManager(log_dir=str(tmp_path / "jobs"))
        job = mgr.submit(f"{sys.executable} torch_capacity_job.py --address {info['address']} "
                         f"--seed 3 --device cpu", working_dir=REPO)
        assert mgr.wait(job, timeout=120).value == "SUCCEEDED", mgr.logs(job)
        line = next(ln for ln in mgr.logs(job).splitlines() if ln.startswith("capacity-job "))
        out = json.loads(line.split(" ", 1)[1])
        assert out["pid"] in [n["pid"] for n in info["nodes"][1:2]]  # the GPU worker
        assert out["launches"] == 0 and out["finite"] and out["max_abs_err"] == 0.0
    finally:
        launcher.down()
    assert all(p.poll() is not None for p in launcher.provider.procs)
    assert _wait_gone(launcher.config["_launch_tag"]) == []


def test_ssh_provider_command_construction():
    provider = SSHLaunchProvider({"ssh_user": "me", "workers": [{"host": "10.0.0.2"}]})
    cmd = _start_cmd(address="10.0.0.1:6379", port=None, num_cpus=8, num_gpus=4,
                     resources={"accel": 4}, token="sekrit", tag="t0")
    full = provider.ssh_command("10.0.0.2", cmd)
    assert full[0] == "ssh"
    assert "me@10.0.0.2" in full
    remote = full[-1]
    assert "-m ray_tpu_torch start --launch-tag t0" in remote
    assert "--address 10.0.0.1:6379" in remote
    assert "--num-cpus 8" in remote
    assert "--num-gpus 4" in remote
    assert "--token sekrit" in remote
    assert remote.startswith("nohup ")
    assert "'{\"accel\": 4}'" in remote  # the resources' JSON is shell-quoted


def test_launcher_gives_gpus_only_where_configured():
    """`--num-gpus` is every node's configured num_gpus, 0 where it has
    none, and 0 for every node under no_cuda."""
    config = {"head": {"num_cpus": 1},
              "workers": [{"num_gpus": 1}, {"num_cpus": 2}]}
    for no_cuda, want in ((False, [0, 1, 0]), (True, [0, 0, 0])):
        launcher = ClusterLauncher(dict(config), no_cuda=no_cuda)
        got = [launcher._num_gpus(n) for n in [config["head"], *config["workers"]]]
        assert got == want


def test_unknown_provider_rejected():
    with pytest.raises(ValueError, match="unknown provider"):
        ClusterLauncher({"provider": "gcp"})


def test_down_pattern_spares_jax_command_lines():
    """`down` kills by a pattern that matches the port's start command lines
    with the launch tag, and no JAX `python -m ray_tpu start` line, even
    one that carries the same tag."""
    tag = "0123abcd4567"
    pattern = re.compile(down_pattern(tag))
    port_head = " ".join(_start_cmd(address=None, port=6379, num_cpus=1, num_gpus=0,
                                    resources=None, token=None, tag=tag))
    port_worker = " ".join(_start_cmd(address="127.0.0.1:6379", port=None, num_cpus=2,
                                      num_gpus=1, resources={"x": 1}, token="t", tag=tag))
    assert pattern.search(port_head) and pattern.search(port_worker)
    jax_lines = [
        f"{sys.executable} -m ray_tpu start --launch-tag {tag} --head --port 6379",
        f"{sys.executable} -m ray_tpu --no-tpu start --launch-tag {tag} --address 1.2.3.4:5",
        f"python -m ray_tpu start --launch-tag {tag}",
    ]
    assert not any(pattern.search(line) for line in jax_lines)
    # another tag, a tag that only starts the same, and the pkill shell itself
    assert not pattern.search(port_head.replace(tag, "ffff" + tag[4:]))
    assert not pattern.search(port_head.replace(tag, tag + "9"))
    assert not pattern.search(f"sh -c pkill -f '{down_pattern(tag)}' || true")
    untagged = re.compile(down_pattern(None))
    assert untagged.search(port_head)
    assert not any(untagged.search(line) for line in jax_lines)


def test_cli_up_down_roundtrip(tmp_path):
    port = _free_port()
    config = {"head": {"port": port, "num_cpus": 1},
              "workers": [{"host": "localhost", "num_cpus": 1}],
              "provider": "local"}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    env = {**os.environ, **FAST_DRAIN}
    up = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "up", str(path)],
                        capture_output=True, text=True, timeout=180, env=env)
    state = {}
    try:
        assert up.returncode == 0, up.stdout + up.stderr
        assert "cluster up: 2 nodes" in up.stdout
        with open(_state_path(str(path))) as f:
            state = json.load(f)
    finally:
        down = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "down", str(path)],
                              capture_output=True, text=True, timeout=60, env=env)
    assert down.returncode == 0, down.stdout + down.stderr
    assert "stopped 2 nodes" in down.stdout
    assert not os.path.exists(_state_path(str(path)))
    assert _wait_gone(state["launch_tag"]) == []


def test_ssh_provider_lifecycle_fake_transport(tmp_path, monkeypatch):
    """The ssh provider through a real up -> join -> down lifecycle over a
    loopback transport: a fake `ssh` records every invocation and runs the
    remote command locally, so the nodes start, register with the head's
    GCS, and die on `down`."""
    from ray_tpu_torch.core.gcs_service import GcsClient

    for k, v in FAST_DRAIN.items():
        monkeypatch.setenv(k, v)
    record = tmp_path / "ssh_record.jsonl"
    fake = tmp_path / "fake_ssh.py"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import json, subprocess, sys\n"
        f"with open({str(record)!r}, 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "proc = subprocess.run(['/bin/sh', '-c', sys.argv[-1]],\n"
        "                      capture_output=True, text=True)\n"
        "sys.stdout.write(proc.stdout)\n"
        "sys.stderr.write(proc.stderr)\n"
        "sys.exit(proc.returncode)\n")
    fake.chmod(0o755)
    port = _free_port()
    config = {"provider": "ssh", "ssh_bin": str(fake),
              "head": {"host": "localhost", "port": port, "num_cpus": 1},
              "workers": [{"host": "localhost", "num_cpus": 1, "resources": {"fake": 1}}]}
    launcher = ClusterLauncher(config)
    try:
        info = launcher.up(wait_s=90)
        assert info["address"].endswith(f":{port}")
        assert len(info["nodes"]) == 2
        client = GcsClient(info["address"])
        try:
            view = client.cluster_view()
            assert len(view["nodes"]) == 2
            assert view["total"].get("fake", 0) == 1
            assert view["total"].get("GPU", 0) == 0
        finally:
            client.close()
        launches = [json.loads(line) for line in record.read_text().splitlines()]
        assert len(launches) == 2
        assert all(a[-1].startswith("nohup ") for a in launches)
        assert "--head" in launches[0][-1]
        assert "--address" in launches[1][-1]
    finally:
        launcher.down()
    invocations = [json.loads(line) for line in record.read_text().splitlines()]
    downs = [a for a in invocations if "pkill" in a[-1]]
    assert len(downs) == 2
    tag = config["_launch_tag"]
    assert all(tag in a[-1] for a in downs)
    assert _wait_gone(tag) == []
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            c = GcsClient(info["address"], timeout=2.0)
            try:
                c.ping()
            finally:
                c.close()
        except Exception:  # noqa: BLE001 - a head that stopped answering
            break
        time.sleep(0.3)
    else:
        raise AssertionError("head still answering after down()")
