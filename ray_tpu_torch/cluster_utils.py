"""Multi-process cluster harness for tests and local experiments.

Port of `ray_tpu/cluster_utils.py`: the head lives in the calling process
(`init(head=True)`) and each `add_node` spawns a real `python -m
ray_tpu_torch start --address=...` process that joins it. What an agent
runs arrives pickled by reference, so the agent must import the driver's
modules: it gets the driver's `sys.path[0]` (the directory of the
driver's script, or its working directory) prepended to its PYTHONPATH.
An agent logs to a file (a pipe nobody drains would stall it); its tail
comes with every error about it (`NodeHandle.tail`).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

from .core.rpc import RpcClient, RpcError


class NodeHandle:
    """One spawned node-agent process."""

    def __init__(self, proc: subprocess.Popen, num_cpus: int, log_path: str):
        self.proc = proc
        self.num_cpus = num_cpus
        self.log_path = log_path

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def logs(self) -> str:
        try:
            with open(self.log_path, "r") as f:
                return f.read()
        except OSError:
            return ""

    def tail(self, n: int = 40) -> str:
        """The last `n` lines of the agent's log."""
        return "\n".join(self.logs().splitlines()[-n:])


class Cluster:
    """Head in-process + node agents as subprocesses.

    Usage::

        cluster = Cluster(head_node_args={"num_cpus": 2})
        cluster.add_node(num_cpus=2)
        cluster.wait_for_nodes(2)
        ... use ray_tpu_torch normally; tasks spill onto the agents ...
        cluster.shutdown()
    """

    def __init__(self, head_node_args: Optional[Dict[str, Any]] = None,
                 token: Optional[str] = None):
        import ray_tpu_torch

        args = dict(head_node_args or {})
        args.setdefault("num_cpus", 2)
        args.setdefault("detect_accelerators", False)
        self.token = token
        self.runtime = ray_tpu_torch.init(head=True, cluster_token=token, **args)
        self.address: str = self.runtime.cluster.gcs_address
        self._nodes: List[NodeHandle] = []

    def add_node(self, num_cpus: int = 1, num_gpus: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None,
                 system_config: Optional[Dict[str, Any]] = None,
                 resources: Optional[Dict[str, float]] = None) -> NodeHandle:
        """Spawn a node agent that joins this cluster. `num_gpus` None
        gives it the CUDA devices it detects; `system_config` sets config
        flags in its environment (`RAY_TPU_<NAME>`)."""
        import json as _json

        cmd = [sys.executable, "-m", "ray_tpu_torch", "start",
               "--address", self.address, "--num-cpus", str(num_cpus)]
        if num_gpus is not None:
            cmd += ["--num-gpus", str(num_gpus)]
        if resources:
            cmd += ["--resources", _json.dumps(resources)]
        if self.token:
            cmd += ["--token", self.token]
        child_env = dict(os.environ)
        # the driver's modules must import in the agent (by-reference export)
        first = os.path.abspath(sys.path[0] or os.getcwd())
        paths = [first] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p]
        child_env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
        for key, value in (system_config or {}).items():
            child_env[f"RAY_TPU_{key.upper()}"] = str(value)
        child_env.update(env or {})
        fd, log_path = tempfile.mkstemp(prefix="ray_tpu_torch_agent_", suffix=".log")
        log_file = os.fdopen(fd, "w")
        try:
            proc = subprocess.Popen(cmd, env=child_env, stdout=log_file,
                                    stderr=subprocess.STDOUT, text=True)
        finally:
            log_file.close()  # the child holds its own descriptor
        handle = NodeHandle(proc, num_cpus, log_path)
        self._nodes.append(handle)
        return handle

    def wait_for_nodes(self, count: int, timeout: float = 60.0) -> None:
        """Block until the scheduler's view holds `count` nodes (head
        included); raises with the log tail of an agent that exited."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.runtime.scheduler.nodes()) >= count:
                return
            for handle in self._nodes:
                if not handle.alive():
                    raise RuntimeError(
                        f"node agent pid={handle.pid} exited rc={handle.proc.returncode}; "
                        f"its log's tail:\n{handle.tail()}")
            time.sleep(0.05)
        tails = "\n".join(f"--- agent pid={h.pid}:\n{h.tail()}" for h in self._nodes)
        raise TimeoutError(
            f"cluster did not reach {count} nodes in {timeout}s "
            f"(have {len(self.runtime.scheduler.nodes())})\n{tails}")

    def remove_node(self, handle: NodeHandle, allow_graceful: bool = True) -> None:
        """Take an agent down. Graceful asks it to stop (it deregisters);
        otherwise SIGKILL simulates a node failure."""
        if allow_graceful and handle.alive():
            try:
                address = self._agent_address(handle)
                if address is not None:
                    client = RpcClient(address, timeout=5.0, retries=0, token=self.token)
                    try:
                        client.call("shutdown_node")
                    finally:
                        client.close()
            except (RpcError, OSError):
                pass
            try:
                handle.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                handle.proc.kill()
        else:
            handle.proc.kill()
        handle.proc.wait()
        if handle in self._nodes:
            self._nodes.remove(handle)
        try:
            os.unlink(handle.log_path)
        except OSError:
            pass

    def _agent_address(self, handle: NodeHandle) -> Optional[str]:
        """The agent address of a spawned node, from the GCS node table."""
        for info in self.runtime.cluster.nodes():
            if info.get("pid") == handle.pid:
                return info["address"]
        return None

    def shutdown(self) -> None:
        """Kill every agent (and reap it), then shut the head down."""
        import ray_tpu_torch

        for handle in list(self._nodes):
            handle.proc.kill()
            handle.proc.wait()
            try:
                os.unlink(handle.log_path)
            except OSError:
                pass
        self._nodes.clear()
        ray_tpu_torch.shutdown()
