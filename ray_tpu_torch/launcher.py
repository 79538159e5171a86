"""Cluster launcher: `python -m ray_tpu_torch up / down <cluster config>`.

Port of `ray_tpu/launcher.py`. The launcher takes an explicit host list,
and two providers cover it:

- ``local``: every node is a subprocess on this machine (the development
  topology; also what `cluster_utils` uses).
- ``ssh``: one `python -m ray_tpu_torch start` per remote host over plain
  ssh (the binary is the config's ``ssh_bin``, so a test can loop it back).

Config (YAML or JSON; JSON where PyYAML is missing)::

    head:
      port: 6379
      num_cpus: 8
      num_gpus: 0
    workers:
      - host: localhost        # or 10.0.0.2 for ssh
        num_cpus: 8
        num_gpus: 1
        resources: {"accel": 1}
    provider: local            # or ssh
    token: my-cluster-secret   # required off localhost
    ssh_user: me               # ssh provider only

Every node is started with `--num-gpus`: its ``num_gpus`` (0 where the
config gives none, and 0 for every node under ``no_cuda``), so a node
advertises a GPU only where its config gives it one; JAX's launcher
passes `--no-tpu` or lets the node detect its chips. Each node carries
`--launch-tag <tag>`, and `down` kills by a pattern that matches only
this package's `ray_tpu_torch start` command lines with that tag: a JAX
cluster's agents on the same host, even under the same tag, are never
touched.
"""

from __future__ import annotations

import json
import os
import re
import shlex
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return json.loads(text)
    return yaml.safe_load(text)


def _start_cmd(*, address: Optional[str], port: Optional[int],
               num_cpus: Optional[int], num_gpus: Optional[int],
               resources: Optional[Dict[str, float]], token: Optional[str],
               tag: Optional[str] = None) -> List[str]:
    cmd = [sys.executable, "-m", "ray_tpu_torch", "start"]
    if tag:
        # identification only: lets `down` target this cluster's agents by
        # their command line without touching a co-tenant cluster's
        cmd += ["--launch-tag", tag]
    if address:
        cmd += ["--address", address]
    else:
        cmd += ["--head", "--port", str(port or 6379)]
    if num_cpus is not None:
        cmd += ["--num-cpus", str(num_cpus)]
    if num_gpus is not None:
        cmd += ["--num-gpus", str(num_gpus)]
    if resources:
        cmd += ["--resources", json.dumps(resources)]
    if token:
        cmd += ["--token", token]
    return cmd


def down_pattern(tag: Optional[str]) -> str:
    """The extended regex (`pkill -f`) that `down` kills by: this
    package's `start` command lines, with the launch tag when there is
    one."""
    if tag:
        return f"ray_tpu_torch start .*--launch-tag {re.escape(tag)}( |$)"
    return "ray_tpu_torch start( |$)"


class LocalLaunchProvider:
    """Every node is a subprocess of this machine."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.procs: List[subprocess.Popen] = []
        self.log_paths: List[str] = []

    def launch(self, cmd: List[str], host: str) -> Dict[str, Any]:
        fd, log_path = tempfile.mkstemp(prefix="ray_tpu_torch_up_", suffix=".log")
        with os.fdopen(fd, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True,
                                    env=dict(os.environ))
        self.procs.append(proc)
        self.log_paths.append(log_path)
        return {"host": host, "pid": proc.pid, "log": log_path}

    def terminate_all(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


class SSHLaunchProvider:
    """One `ray_tpu_torch start` per remote host over ssh. The remote host
    must have the same ray_tpu_torch importable (the membership protocol
    checks it) and be reachable."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.user = config.get("ssh_user")
        self.ssh_opts = config.get("ssh_opts", ["-o", "StrictHostKeyChecking=no"])
        # the transport can be swapped: tests drive up -> join -> down
        # through a loopback fake instead of a real ssh binary
        self.ssh_bin = config.get("ssh_bin", "ssh")
        self.procs: List[subprocess.Popen] = []

    def ssh_command(self, host: str, cmd: List[str]) -> List[str]:
        target = f"{self.user}@{host}" if self.user else host
        remote = " ".join(shlex.quote(part) for part in cmd)
        # nohup: the agent must outlive the ssh session
        return [self.ssh_bin, *self.ssh_opts, target,
                f"nohup {remote} >${{TMPDIR:-/tmp}}/ray_tpu_torch_agent.log 2>&1 & echo $!"]

    def launch(self, cmd: List[str], host: str) -> Dict[str, Any]:
        proc = subprocess.Popen(self.ssh_command(host, cmd), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        self.procs.append(proc)
        return {"host": host, "ssh_pid": proc.pid}

    def terminate_all(self) -> None:
        # best effort, the head included: kill this cluster's agents by the
        # launch tag in their command line on every configured host
        pattern = down_pattern(self.config.get("_launch_tag", ""))
        hosts = [self.config.get("head", {}).get("host", "localhost")] + [
            w.get("host", "localhost") for w in self.config.get("workers", [])
        ]
        for host in hosts:
            target = f"{self.user}@{host}" if self.user else host
            try:
                subprocess.run([self.ssh_bin, *self.ssh_opts, target,
                                f"pkill -f {shlex.quote(pattern)} || true"],
                               capture_output=True, timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                pass
        for proc in self.procs:  # the ssh sessions themselves
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if proc.stdout is not None:
                proc.stdout.close()


_PROVIDERS = {"local": LocalLaunchProvider, "ssh": SSHLaunchProvider}


class ClusterLauncher:
    """Bring up the head and every configured worker, wait until they
    registered, and report the address to join."""

    def __init__(self, config: Dict[str, Any], *, no_cuda: bool = False):
        self.config = config
        provider_name = config.get("provider", "local")
        if provider_name not in _PROVIDERS:
            raise ValueError(f"unknown provider {provider_name!r}; known: {sorted(_PROVIDERS)}")
        self.provider = _PROVIDERS[provider_name](config)
        self.no_cuda = no_cuda
        self.address: Optional[str] = None

    def _num_gpus(self, node: Dict[str, Any]) -> int:
        return 0 if self.no_cuda else int(node.get("num_gpus", 0))

    def up(self, wait_s: float = 60.0) -> Dict[str, Any]:
        import uuid

        head = self.config.get("head", {})
        token = self.config.get("token")
        tag = self.config.setdefault("_launch_tag", uuid.uuid4().hex[:12])
        port = int(head.get("port", 6379))
        head_host = head.get("host", "localhost")
        head_cmd = _start_cmd(address=None, port=port, num_cpus=head.get("num_cpus"),
                              num_gpus=self._num_gpus(head), resources=head.get("resources"),
                              token=token, tag=tag)
        head_info = self.provider.launch(head_cmd, head_host)
        connect_host = "127.0.0.1" if head_host == "localhost" else head_host
        self.address = f"{connect_host}:{port}"
        workers = self.config.get("workers", [])
        launched = [head_info]
        try:
            self._wait_for_nodes(1, wait_s)  # the workers must not race the GCS socket
            for w in workers:
                cmd = _start_cmd(address=self.address, port=None, num_cpus=w.get("num_cpus"),
                                 num_gpus=self._num_gpus(w), resources=w.get("resources"),
                                 token=token, tag=tag)
                launched.append(self.provider.launch(cmd, w.get("host", "localhost")))
            self._wait_for_nodes(1 + len(workers), wait_s)
        except BaseException:
            # a half-up cluster must not orphan detached agents the user
            # can never `down` (no state file was written yet)
            self.provider.terminate_all()
            raise
        return {"address": self.address, "nodes": launched}

    def _wait_for_nodes(self, count: int, wait_s: float) -> None:
        from .core.gcs_service import GcsClient

        deadline = time.monotonic() + wait_s
        client = GcsClient(self.address, token=self.config.get("token"))
        try:
            while time.monotonic() < deadline:
                try:
                    if len(client.cluster_view()["nodes"]) >= count:
                        return
                except Exception:  # noqa: BLE001 - the head may not listen yet
                    pass
                time.sleep(0.25)
            raise TimeoutError(f"cluster did not reach {count} nodes within {wait_s}s")
        finally:
            client.close()

    def down(self) -> None:
        """Terminate everything this launcher started."""
        self.provider.terminate_all()


# ------------------------------------------------------------ CLI state file
# `up` returns once the nodes run (detached); `down`, in a fresh process,
# finds them through one JSON state file per config under the home
# directory.


def _state_path(config_path: str) -> str:
    import hashlib

    digest = hashlib.sha256(os.path.abspath(config_path).encode()).hexdigest()[:16]
    state_dir = os.path.join(os.path.expanduser("~"), ".ray_tpu_torch")
    os.makedirs(state_dir, exist_ok=True)
    return os.path.join(state_dir, f"launch_{digest}.json")


def up_from_cli(config_path: str, *, no_cuda: bool = False) -> Dict[str, Any]:
    config = load_config(config_path)
    launcher = ClusterLauncher(config, no_cuda=no_cuda)
    info = launcher.up()
    state = {
        "address": info["address"],
        "provider": config.get("provider", "local"),
        "pids": [n.get("pid") for n in info["nodes"] if n.get("pid")],
        "launch_tag": config.get("_launch_tag"),
        "config_path": os.path.abspath(config_path),
    }
    with open(_state_path(config_path), "w") as f:
        json.dump(state, f)
    return info


def down_from_cli(config_path: str) -> int:
    """Terminate a cluster started by up_from_cli; returns the nodes stopped."""
    import signal

    path = _state_path(config_path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no launch state for {config_path} (was `up` run here?)")
    with open(path) as f:
        state = json.load(f)
    stopped = 0
    if state["provider"] == "local":
        pattern = re.compile(down_pattern(state.get("launch_tag")))
        for pid in state.get("pids", []):
            # pids recycle: check that the target still is one of this
            # cluster's nodes before signalling it
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmdline = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            except OSError:
                continue
            if not pattern.search(cmdline):
                continue
            try:
                os.kill(pid, signal.SIGTERM)
                stopped += 1
            except ProcessLookupError:
                pass
    else:
        config = load_config(state["config_path"])
        config["_launch_tag"] = state.get("launch_tag", "")
        SSHLaunchProvider(config).terminate_all()
        stopped = len(config.get("workers", [])) + 1
    os.unlink(path)
    return stopped
