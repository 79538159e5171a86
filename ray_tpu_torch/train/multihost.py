"""Multi-process gang: one OS process per rank, torch.distributed inside.

Port of `ray_tpu/train/multihost.py`. Each rank is a `WorkerProcess`
child (`core/worker_pool.py`, started as its own program, never forked)
that calls `init_process_group(backend, store=..., rank, world_size)`
where JAX's hosts call `jax.distributed.initialize`, runs the train
function and calls `destroy_process_group` at the end. From there the
ranks' `build_mesh(spec)` spans the job (dp, fsdp, tp), and the train step
syncs over its process groups.

Rendezvous: the parent holds a `TCPStore` bound to port 0 (the kernel
picks a free port, so gangs started side by side never collide) and the
ranks join it as clients. The backend is the caller's, or NCCL when
every rank can have its own CUDA device and gloo otherwise (NCCL refuses
two ranks on one device: "Duplicate GPU detected"); nothing switches
backend after a failure. `timeout_s` bounds every collective of the job
and the start-up, so a hung rank raises instead of holding the gang.

Reports stream through per-rank jsonl files (the pipe is request/reply
lockstep), and the controller's preemption flags reach the ranks the
other way through one flags json file, as in JAX.
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.worker_pool import WorkerProcess
from .session import Session, TrainContext, _set_session


class _FileSession(Session):
    """Session that also appends each report to a jsonl file the parent
    tails (out-of-band streaming; the pipe stays request/reply). The
    controller's preemption flags arrive the same way, inverted: a flags
    json file next to the report files, probed by should_checkpoint()/
    is_preempted()."""

    def __init__(self, context: TrainContext, path: str,
                 flags_path: Optional[str] = None):
        super().__init__(context)
        self._path = path
        if flags_path is not None:
            def probe() -> Dict[str, Any]:
                try:
                    with open(flags_path) as f:
                        return json.load(f)
                except (OSError, ValueError):
                    return {}

            self._flag_probe = probe

    def report(self, metrics, checkpoint_step=None, checkpoint=None) -> None:
        super().report(metrics, checkpoint_step, checkpoint)
        rec = {
            "metrics": dict(metrics),
            "checkpoint_step": checkpoint_step,
            "rank": self.context.world_rank,
            "ts": time.time(),
        }
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()


def _free_port() -> int:
    """A TCP port free on this host right now (the caller races anyone who
    binds it before the rendezvous does)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(num_processes: int) -> str:
    """NCCL when every rank of one host can have its own CUDA device,
    gloo otherwise (CPU ranks, or ranks that share a card)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def _host_entry(
    train_fn: Callable,
    config: Optional[Dict[str, Any]],
    store_addr: Tuple[str, int],
    num_processes: int,
    process_id: int,
    run_name: str,
    report_path: str,
    flags_path: Optional[str] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
    run_index: int = 0,
):
    """Runs inside the rank's process (module-level: pickled by reference).
    Each run of the gang rendezvouses under a key prefix of its own, so a
    later run's `init_process_group` never reads an earlier run's keys."""
    import torch
    import torch.distributed as dist

    if num_processes > 1:
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore(store_addr[0], store_addr[1], is_master=False, timeout=timeout)
        store = dist.PrefixStore(f"run{run_index}/", store)
        backend = backend or default_backend(num_processes)
        if backend == "nccl":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(backend, store=store, rank=process_id,
                                world_size=num_processes, timeout=timeout)
    ctx = TrainContext(
        world_rank=process_id, world_size=num_processes, run_name=run_name
    )
    session = _FileSession(ctx, report_path, flags_path)
    _set_session(session)
    try:
        return train_fn(config) if config is not None else train_fn()
    finally:
        _set_session(None)
        if num_processes > 1:
            dist.destroy_process_group()


class MultihostWorkerGroup:
    """Drop-in WorkerGroup sibling whose workers are OS processes forming
    one torch.distributed job. Same start/run_async/poll/finish/shutdown
    surface, so TrainController can drive either (`group_factory=`)."""

    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Optional[Dict[str, float]] = None,
        run_name: str = "train_run",
        env_per_worker: Optional[List[Dict[str, str]]] = None,
        report_dir: Optional[str] = None,
        backend: Optional[str] = None,
        timeout_s: float = 600.0,
    ):
        self.num_workers = num_workers
        self.run_name = run_name
        self.env_per_worker = env_per_worker
        self.report_dir = report_dir or tempfile.mkdtemp(prefix=f"raytpu-{run_name}-")
        self.backend = backend
        self.timeout_s = timeout_s
        self.workers: List[WorkerProcess] = []
        self._futures: List[Future] = []
        self._store = None
        self._runs = 0  # run_async calls so far: each run's rendezvous prefix

    def _report_path(self, rank: int) -> str:
        return os.path.join(self.report_dir, f"reports_rank{rank}.jsonl")

    def _flags_path(self) -> str:
        # one shared flags file: a preemption concerns the whole gang
        return os.path.join(self.report_dir, "preempt_flags.json")

    def start(self) -> None:
        os.makedirs(self.report_dir, exist_ok=True)
        if self.num_workers > 1:
            import torch.distributed as dist

            self._store = dist.TCPStore(
                "127.0.0.1", 0, is_master=True, wait_for_workers=False,
                timeout=datetime.timedelta(seconds=self.timeout_s))
        for rank in range(self.num_workers):
            env = dict(self.env_per_worker[rank]) if self.env_per_worker else {}
            self.workers.append(WorkerProcess(env))
        # liveness check (reference: BackendExecutor pings the gang)
        for w in self.workers:
            w.request("ping", timeout=self.timeout_s)

    def run_async(self, train_fn: Callable, config: Optional[Dict[str, Any]]):
        """Launch the SPMD loop on every rank; returns per-rank Futures. A
        gang may run one function after another (each run is a job of its
        own: `init_process_group` to `destroy_process_group`)."""
        self._futures = [Future() for _ in self.workers]
        store_addr = ("127.0.0.1", self._store.port) if self._store is not None else None
        run_index, self._runs = self._runs, self._runs + 1

        def drive(rank: int, worker: WorkerProcess, fut: Future) -> None:
            payload = (
                _host_entry,
                (
                    train_fn,
                    config,
                    store_addr,
                    self.num_workers,
                    rank,
                    self.run_name,
                    self._report_path(rank),
                    self._flags_path(),
                    self.backend,
                    self.timeout_s,
                    run_index,
                ),
                {},
            )
            try:
                fut.set_result(worker.request("task", payload))
            except BaseException as e:  # noqa: BLE001 - ferried to the controller
                fut.set_exception(e)

        for rank, (w, f) in enumerate(zip(self.workers, self._futures)):
            threading.Thread(
                target=drive, args=(rank, w, f), daemon=True,
                name=f"{self.run_name}-rank-{rank}",
            ).start()
        return self._futures

    def poll(self, since: List[int], should_checkpoint: bool = False,
             preempted: bool = False,
             preempt_deadline: float = 0.0) -> List[Dict[str, Any]]:
        """Same shape as WorkerGroup.poll: reports past each cursor, plus
        done/error state, per worker. Preemption flags cross the process
        boundary via an atomically-replaced json file the workers'
        sessions probe."""
        if should_checkpoint or preempted:
            flags = {
                "should_checkpoint": should_checkpoint,
                "preempted": preempted,
                "deadline": preempt_deadline,
            }
            tmp = self._flags_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(flags, f)
            os.replace(tmp, self._flags_path())
        out = []
        for rank, (w, fut) in enumerate(zip(self.workers, self._futures)):
            reports = []
            path = self._report_path(rank)
            if os.path.exists(path):
                with open(path) as f:
                    lines = f.read().splitlines()
                for line in lines[since[rank]:]:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # torn tail write; re-read next poll
                    reports.append(
                        (rec["metrics"], rec["checkpoint_step"], rec["rank"], rec["ts"])
                    )
            error = None
            if fut.done() and fut.exception() is not None:
                error = repr(fut.exception())
            if not w.alive() and not fut.done():
                error = f"rank {rank} process died (pid {w.pid})"
            out.append({"reports": reports, "done": fut.done(), "error": error})
        return out

    def finish(self, result_refs, timeout: Optional[float] = None):
        return [f.result(timeout) for f in result_refs]

    def pids(self) -> List[int]:
        return [w.pid for w in self.workers]

    def shutdown(self) -> None:
        for w in self.workers:
            w.kill()
        self.workers = []
        self._futures = []
        self._store = None
