"""Runtime environments: per-task / per-actor env_vars, py_modules, working_dir.

Port of `ray_tpu/core/runtime_env.py`. `normalize` validates a caller's
dict; `applied` scopes one around an execution body in this process:

- env_vars: os.environ is process-global, so thread tasks carrying
  env_vars serialize on one lock for the duration of their body, applied
  then restored. Tasks without a runtime env take no lock.
- py_modules: local paths put at the front of sys.path for the call (and
  left there: imports are cached anyway).
- working_dir: only a process worker can run in another directory (the
  cwd is process-global); the runtime refuses it on thread tasks and
  actors, and a worker process starts in it.

Process workers (`executor="process"`) get true isolation: the env is
exported to the worker's own environment instead (`worker_pool.py`).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Any, Dict, Optional

_env_lock = threading.RLock()


def normalize(runtime_env: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if not runtime_env:
        return None
    known = {"env_vars", "py_modules", "working_dir"}
    unknown = set(runtime_env) - known
    if unknown:
        raise ValueError(
            f"unsupported runtime_env keys {sorted(unknown)}; supported: {sorted(known)}"
        )
    env_vars = runtime_env.get("env_vars") or {}
    if not all(isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()):
        raise TypeError("env_vars must be Dict[str, str]")
    working_dir = runtime_env.get("working_dir")
    if working_dir is not None:
        working_dir = os.path.abspath(os.fspath(working_dir))
        if not os.path.isdir(working_dir):
            raise ValueError(f"working_dir {working_dir!r} is not a directory")
    return {
        "env_vars": dict(env_vars),
        "py_modules": [os.fspath(p) for p in runtime_env.get("py_modules") or []],
        "working_dir": working_dir,
    }


def worker_env_vars(runtime_env: Optional[Dict[str, Any]]) -> Dict[str, str]:
    """The environment variables a worker process starts with: the env's
    env_vars, with its py_modules at the front of PYTHONPATH."""
    renv = runtime_env or {}
    env_vars = dict(renv.get("env_vars") or {})
    py_modules = renv.get("py_modules") or []
    if py_modules:
        existing = env_vars.get("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
        env_vars["PYTHONPATH"] = os.pathsep.join(
            list(py_modules) + ([existing] if existing else [])
        )
    return env_vars


@contextlib.contextmanager
def applied(runtime_env: Optional[Dict[str, Any]]):
    """Apply a (normalized) runtime env around an execution body."""
    if not runtime_env:
        yield
        return
    for path in runtime_env["py_modules"]:
        if path not in sys.path:
            sys.path.insert(0, path)
    env_vars: Dict[str, str] = runtime_env["env_vars"]
    if not env_vars:
        yield
        return
    with _env_lock:
        saved: Dict[str, Optional[str]] = {k: os.environ.get(k) for k in env_vars}
        os.environ.update(env_vars)
        try:
            yield
        finally:
            for k, old in saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
