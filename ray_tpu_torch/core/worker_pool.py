"""Worker processes: one OS process per worker, driven over a pipe.

Port of `WorkerCrashedError`, `_worker_main` and `WorkerProcess` from
`ray_tpu/core/worker_pool.py`. A worker is started as its own program,
`python -m ray_tpu_torch.core.worker_main <fd>`, through
`subprocess.Popen` over an inherited socketpair: it is never forked from
a parent that may have touched CUDA, and it never re-imports the
caller's `__main__`. The multihost gang (`train/multihost.py`) runs one
rank in each.

What differs from JAX, and why: frames are pickled with the standard
`pickle`, where JAX's use `cloudpickle` (the port depends on nothing
past torch and numpy). A function sent to a worker is pickled by
reference, so it must be importable in the child: defined at module
level, not a lambda or a nested function (ROADMAP §C). The reusable
`ProcessWorkerPool` and `executor="process"` come with ROADMAP A5.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Connection
from typing import Any, Dict, Optional

from .exceptions import TaskError

logger = logging.getLogger(__name__)


class WorkerCrashedError(TaskError):
    """The worker process died mid-task (killed, OOM, segfault)."""

    def __init__(self, message: str):
        # TaskError(function_name, cause) signature; we are our own cause
        Exception.__init__(self, message)
        self.function_name = "<process-worker>"
        self.cause = None
        self.remote_traceback = ""

    def __reduce__(self):
        return (WorkerCrashedError, (self.args[0] if self.args else "",))


def _worker_main(conn: Connection, env_vars: Dict[str, str]) -> None:
    """Child process loop: receive a request frame, run it, reply.

    Runs callers' functions only: no runtime state lives in the child."""
    os.environ.update(env_vars or {})
    home_cwd = os.getcwd()
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        kind = msg[0]
        if kind == "shutdown":
            conn.close()
            return
        if kind == "ping":
            conn.send(("ok", pickle.dumps(os.getpid())))
            continue
        try:
            if os.getcwd() != home_cwd:
                os.chdir(home_cwd)
        except OSError:
            pass
        try:
            if kind != "task":
                raise ValueError(f"unknown message kind {kind!r}")
            func, args, kwargs = pickle.loads(msg[1])
            conn.send(("ok", pickle.dumps(func(*args, **kwargs))))
        except BaseException as exc:  # noqa: BLE001 - remote error boundary
            tb = traceback.format_exc()
            try:
                payload = pickle.dumps(exc)
            except Exception:  # noqa: BLE001 - an exception pickle cannot carry
                payload = pickle.dumps(RuntimeError(repr(exc)))
            conn.send(("err", payload, tb))


class WorkerProcess:
    """One spawned worker and its pipe. Not thread-safe: one request at a
    time.

    The child resolves by-reference pickles against the parent's import
    path: `sys.path` ('' materialised as the parent's cwd) leads its
    PYTHONPATH."""

    def __init__(self, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None):
        parent_sock, child_sock = socket.socketpair()
        env = dict(os.environ)
        env.update(env_vars or {})
        paths = [p or os.getcwd() for p in sys.path] + (
            [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []
        )
        if working_dir:
            paths.insert(0, working_dir)
        env["PYTHONPATH"] = os.pathsep.join(paths)
        child_fd = child_sock.fileno()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.worker_main", str(child_fd)],
            pass_fds=[child_fd],
            env=env,
            cwd=working_dir,
            close_fds=True,
        )
        child_sock.close()
        self._conn = Connection(parent_sock.detach())
        self.last_used = time.monotonic()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def request(self, kind: str, payload: Any = None, timeout: Optional[float] = None):
        """Send one request frame and block for the reply.

        Raises the ORIGINAL remote exception (its traceback attached as
        .remote_traceback); raises WorkerCrashedError only when the
        process dies, and TimeoutError past `timeout` seconds."""
        try:
            if payload is None:
                self._conn.send((kind,))
            else:
                self._conn.send((kind, pickle.dumps(payload)))
        except (OSError, ValueError) as e:
            raise WorkerCrashedError(f"worker {self.pid} pipe broke on send: {e!r}")
        if kind == "shutdown":
            return None
        deadline = None if timeout is None else time.monotonic() + timeout
        start = time.monotonic()
        next_warn = start + 30.0
        while True:
            wait = 0.2 if deadline is None else min(0.2, deadline - time.monotonic())
            if wait <= 0:
                raise TimeoutError(f"worker {self.pid} request timed out")
            if self._conn.poll(wait):
                break
            now = time.monotonic()
            if now >= next_warn:
                logger.warning(
                    "worker %d has not replied to %r for %.0fs (still alive; "
                    "possibly wedged in user code)", self.pid, kind, now - start,
                )
                next_warn = now + 30.0
            if not self.alive():
                raise WorkerCrashedError(
                    f"worker process {self.pid} died (exitcode "
                    f"{self.proc.returncode}) during {kind}"
                )
        try:
            reply = self._conn.recv()
        except (EOFError, OSError) as e:
            raise WorkerCrashedError(f"worker {self.pid} pipe broke: {e!r}")
        self.last_used = time.monotonic()
        if reply[0] == "ok":
            return pickle.loads(reply[1])
        exc = pickle.loads(reply[1])
        if not isinstance(exc, BaseException):
            exc = RuntimeError(repr(exc))
        exc.remote_traceback = reply[2]
        raise exc

    def kill(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                try:
                    self.proc.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    pass

    def shutdown(self) -> None:
        try:
            self.request("shutdown")
        except WorkerCrashedError:
            pass
        try:
            self.proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            self.kill()
