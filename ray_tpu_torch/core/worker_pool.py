"""Process-backed worker pool: OS-process execution for tasks and actors.

Port of `ray_tpu/core/worker_pool.py`. Threads stay the default executor
(CUDA tensors pass between threads by reference); the process pool is
the opt-in path for CPU-bound Python work (Data map functions,
tokenisation, decoding) where the interpreter lock would serialise
thread workers: `@remote(executor="process")`, `.options(executor=
"process")`, process actors, `map_batches(..., executor="process")`.

A worker is started as its own program, `python -m
ray_tpu_torch.core.worker_main <fd>`, through `subprocess.Popen` over an
inherited socketpair: it is never forked from a parent that may have
touched CUDA, and it never re-imports the caller's `__main__`. The
multihost gang (`train/multihost.py`) runs one rank in each. Workers are
reused across tasks, keyed by runtime env (env_vars, working_dir), idle
ones reaped after `cfg.worker_idle_timeout_s`, at most
`cfg.max_process_workers` of them (0: one per core, at least 2).
ObjectRef args are resolved in the parent and shipped by value, an
SHM-tier value as a descriptor the worker maps (`object_store.
resolve_process_args`); the child does not join the runtime.

What differs from JAX, and why:
- Frames are pickled with the standard `pickle`, where JAX's use
  `cloudpickle` (the port depends on nothing past torch and numpy). A
  function or class sent to a worker is pickled by reference, so it must
  be importable in the child: defined at module level, not a lambda, a
  nested function or in `__main__`. The runtime checks this when a task
  or actor is submitted (`check_importable`), not as a failure in the
  child.
- No CUDA tensor crosses a worker's pipe (`dumps`): unpickling one in a
  child would create a CUDA context there (about 0.5 GB of the card per
  worker, and seconds of start-up). The frame is refused with a
  TypeError before anything is sent; pass `.cpu()` tensors or numpy.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import Connection
from typing import Any, Dict, List, Optional

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


CUDA_TENSOR_RULE = (
    "a CUDA tensor cannot be sent to a worker process or through a shared-memory "
    "channel: unpickling it there would create a CUDA context in that process. "
    "Pass tensor.cpu() (or a numpy array) instead"
)
IMPORTABLE_RULE = (
    "ray_tpu_torch sends it to the worker process with the standard pickle, by "
    "reference (there is no cloudpickle), so it must be importable there: define it "
    "at module level in an importable module, not as a lambda, a nested function or "
    "in __main__"
)


class _WirePickler(pickle.Pickler):
    """The standard pickler, refusing CUDA tensors (CUDA_TENSOR_RULE)."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor) and obj.is_cuda:
            raise TypeError(CUDA_TENSOR_RULE)
        return NotImplemented


def dumps(obj: Any) -> bytes:
    """Pickle a frame for a worker's pipe or a shared-memory channel."""
    buf = io.BytesIO()
    _WirePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def check_importable(obj: Any, what: str) -> None:
    """Raise TypeError, naming the rule, unless `obj` (a function or a
    class) pickles by reference to a module a worker can import."""
    if getattr(obj, "__module__", None) == "__main__":
        raise TypeError(f"{what} {obj!r} is defined in __main__: {IMPORTABLE_RULE}")
    try:
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise TypeError(f"{what} {obj!r} cannot be pickled ({exc}): {IMPORTABLE_RULE}") from None


def _worker_main(conn: Connection, env_vars: Dict[str, str]) -> None:
    """Child process loop: receive a request frame, run it, reply.

    Runs callers' functions only: no runtime state lives in the child.
    Frames: ("task", (func, args, kwargs)), ("actor_create", (cls, args,
    kwargs)) and then ("actor_call", (method, args, kwargs)) on the
    instance, ("ping",), ("shutdown",)."""
    os.environ.update(env_vars or {})
    # the cwd (working_dir or the parent's) is part of the pool's reuse
    # contract: one task's os.chdir must not leak into the next
    home_cwd = os.getcwd()
    actor = None  # set by actor_create; actor_call dispatches onto it
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
            if kind == "task":
                func, args, kwargs = pickle.loads(msg[1])
                result = func(*args, **kwargs)
            elif kind == "actor_create":
                cls, args, kwargs = pickle.loads(msg[1])
                actor = cls(*args, **kwargs)
                result = os.getpid()
            elif kind == "actor_call":
                method_name, args, kwargs = pickle.loads(msg[1])
                if method_name == "__ray_ready__":
                    result = True
                elif method_name == "__ray_pid__":
                    result = os.getpid()
                elif method_name == "__ray_apply__":
                    # fn(instance, *args) inside the worker: the compiled
                    # graph's loop over shared-memory channels
                    result = args[0](actor, *args[1:], **kwargs)
                else:
                    result = getattr(actor, method_name)(*args, **kwargs)
            else:
                raise ValueError(f"unknown message kind {kind!r}")
            conn.send(("ok", pickle.dumps(result, protocol=pickle.HIGHEST_PROTOCOL)))
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
        self.env_key = _env_key(env_vars, working_dir)
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
        process dies, and TimeoutError past `timeout` seconds. A payload
        holding a CUDA tensor raises TypeError before anything is sent."""
        frame = (kind,) if payload is None else (kind, dumps(payload))
        try:
            self._conn.send(frame)
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


def _env_key(env_vars: Optional[Dict[str, str]], working_dir: Optional[str] = None):
    return (tuple(sorted((env_vars or {}).items())), working_dir)


class ProcessWorkerPool:
    """Reusable pool of worker processes, keyed by runtime env.

    acquire() prefers an idle worker with a matching env, spawns when none
    is idle and the pool is under max_workers, evicts an idle worker of
    another env when full, and blocks otherwise. Idle workers past the
    reap timeout are shut down by the next acquire."""

    def __init__(self, max_workers: Optional[int] = None):
        from .config import cfg

        self.max_workers = max_workers or (
            cfg.max_process_workers or max(2, os.cpu_count() or 4)
        )
        self._idle_reap_s = cfg.worker_idle_timeout_s
        self._idle: List[WorkerProcess] = []  # guarded-by: _lock|_free
        self._busy: List[WorkerProcess] = []  # guarded-by: _lock|_free
        self._spawning = 0  # in-flight spawn slots  # guarded-by: _lock|_free
        self._closed = False  # guarded-by: _lock|_free
        self._lock = threading.Lock()
        self._free = threading.Condition(self._lock)
        self._reapers: List[threading.Thread] = []  # guarded-by: _lock|_free
        self.stats = {"spawned": 0, "reused": 0, "reaped": 0, "crashed": 0}

    def _kill_async(self, worker: WorkerProcess) -> None:  # holds-lock: _free
        """terminate + wait off-thread: kill() waits up to 3 s and must never
        run under the pool lock. shutdown() joins these threads."""
        thread = threading.Thread(target=worker.kill, daemon=True,
                                  name="ray_tpu_torch-worker-reaper")
        self._reapers = [t for t in self._reapers if t.is_alive()] + [thread]
        thread.start()

    def acquire(self, env_vars: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None,
                working_dir: Optional[str] = None) -> WorkerProcess:
        key = _env_key(env_vars, working_dir)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._free:
            while True:
                if self._closed:
                    raise RuntimeError("worker pool is shut down")
                self._reap_locked()
                for i, w in enumerate(self._idle):
                    if w.env_key == key and w.alive():
                        self._idle.pop(i)
                        self._busy.append(w)
                        self.stats["reused"] += 1
                        return w
                if len(self._idle) + len(self._busy) + self._spawning < self.max_workers:
                    self._spawning += 1  # reserve the slot, spawn outside the lock
                    break
                if self._idle:  # full: evict an idle worker of another env
                    self._kill_async(self._idle.pop(0))
                    continue
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("no process worker available")
                self._free.wait(timeout=0.2 if remaining is None else min(0.2, remaining))
        try:
            worker = WorkerProcess(dict(env_vars or {}), working_dir=working_dir)
        except BaseException:
            with self._free:
                self._spawning -= 1
                self._free.notify_all()
            raise
        with self._free:
            self._spawning -= 1
            self._busy.append(worker)
            self.stats["spawned"] += 1
        return worker

    def release(self, worker: WorkerProcess, crashed: bool = False) -> None:
        with self._free:
            if worker in self._busy:
                self._busy.remove(worker)
            if crashed or self._closed or not worker.alive():
                # a release after shutdown() kills the worker instead of
                # idling it into a pool nothing will ever reap
                self.stats["crashed"] += crashed
                self._kill_async(worker)
            else:
                self._idle.append(worker)
            self._free.notify_all()

    def _reap_locked(self) -> None:  # holds-lock: _free
        now = time.monotonic()
        keep = []
        for w in self._idle:
            if not w.alive() or now - w.last_used > self._idle_reap_s:
                self._kill_async(w)
                self.stats["reaped"] += 1
            else:
                keep.append(w)
        self._idle[:] = keep

    def prestart(self, n: int, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None, timeout: float = 120.0) -> List[int]:
        """Start idle workers for an env until n of them are idle (within
        max_workers), all in parallel, and wait until each answers: a
        worker's start-up (a fresh interpreter importing torch) is then
        paid before the first task. Returns the idle workers' pids."""
        key = _env_key(env_vars, working_dir)
        with self._free:
            if self._closed:
                raise RuntimeError("worker pool is shut down")
            have = sum(w.env_key == key for w in self._idle)
            room = self.max_workers - len(self._idle) - len(self._busy) - self._spawning
            want = max(0, min(n - have, room))
            self._spawning += want
        started: List[WorkerProcess] = []
        try:
            for _ in range(want):
                started.append(WorkerProcess(dict(env_vars or {}), working_dir=working_dir))
            for w in started:
                w.request("ping", timeout=timeout)
        except BaseException:
            for w in started:
                w.kill()
            raise
        finally:
            with self._free:
                self._spawning -= want
                self._free.notify_all()
        with self._free:
            self._idle.extend(started)
            self.stats["spawned"] += len(started)
            return [w.pid for w in self._idle if w.env_key == key]

    def pids(self) -> List[int]:
        """The pids of every pooled worker, idle or busy."""
        with self._lock:
            return [w.pid for w in self._idle + self._busy]

    def execute(self, func, args, kwargs,
                env_vars: Optional[Dict[str, str]] = None,
                working_dir: Optional[str] = None) -> Any:
        """Run one task on a pooled worker (blocking). A crash raises the
        retriable WorkerCrashedError; the task's own exception is raised
        as itself, with the worker's traceback attached."""
        worker = self.acquire(env_vars, working_dir=working_dir)
        crashed = False
        try:
            return worker.request("task", (func, args, kwargs))
        except WorkerCrashedError:
            crashed = True
            raise
        finally:
            self.release(worker, crashed=crashed)

    def num_workers(self) -> int:
        with self._lock:
            return len(self._idle) + len(self._busy)

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop idle workers now and join the reaper threads; busy workers
        are killed by their own release() (their pipes are in use by the
        running task's thread)."""
        with self._free:
            self._closed = True
            idle, self._idle = self._idle, []
        for w in idle:
            w.shutdown()
        with self._free:
            reapers = list(self._reapers)
        deadline = time.monotonic() + timeout
        for t in reapers:
            t.join(max(0.0, deadline - time.monotonic()))


_pool: Optional[ProcessWorkerPool] = None
_pool_lock = threading.Lock()


def get_worker_pool() -> ProcessWorkerPool:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ProcessWorkerPool()
        return _pool


def peek_worker_pool() -> Optional[ProcessWorkerPool]:
    """The process-wide pool if one was started, without starting it."""
    return _pool


def shutdown_worker_pool() -> None:
    global _pool
    with _pool_lock:
        pool, _pool = _pool, None
    if pool is not None:
        pool.shutdown()


def execute_process_task(store, func, args, kwargs, runtime_env):
    """The process-executor dispatch: resolve args (SHM-tier values become
    pinned zero-copy arena descriptors), build the worker's environment
    from the runtime env, run on a pooled worker, and release the pins on
    every path."""
    from .runtime_env import worker_env_vars

    renv = runtime_env or {}
    release_a = release_k = None
    try:
        resolved_args, release_a = store.resolve_process_args(tuple(args))
        resolved_kwargs, release_k = store.resolve_process_args(dict(kwargs))
        return get_worker_pool().execute(
            func, resolved_args, resolved_kwargs, env_vars=worker_env_vars(renv),
            working_dir=renv.get("working_dir"),
        )
    finally:
        if release_a is not None:
            release_a()
        if release_k is not None:
            release_k()
