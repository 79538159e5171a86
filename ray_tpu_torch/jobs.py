"""Job submission: supervised entrypoint subprocesses with captured logs.

Port of `ray_tpu/jobs.py`. Each job is an entrypoint command run as a
subprocess in its own process group, with the repository root first on
its PYTHONPATH (so `import ray_tpu_torch` works in the job) and its id in
`RAY_TPU_JOB_ID`; its stdout and stderr go to a per-job log file, and a
watcher thread tracks its status (PENDING -> RUNNING -> SUCCEEDED /
FAILED / STOPPED). A cluster head's GCS snapshot carries the default
manager's records (`Runtime._snapshot_gcs`); a restored head marks a job
that was still running FAILED, since its process died with the old head.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import shlex
import signal
import subprocess
import threading
import time
import uuid
from typing import Dict, List, Optional


class JobStatus(enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


@dataclasses.dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: JobStatus
    log_path: str
    submitted_at: float
    finished_at: Optional[float] = None
    returncode: Optional[int] = None
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)


class JobManager:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch_jobs"
        )
        os.makedirs(self.log_dir, exist_ok=True)
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit(
        self,
        entrypoint: str,
        *,
        job_id: Optional[str] = None,
        env_vars: Optional[Dict[str, str]] = None,
        working_dir: Optional[str] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        # validate before registering: a late Popen TypeError must not
        # leave a phantom PENDING job in the table (a payload can carry
        # any JSON type)
        if not isinstance(entrypoint, str) or not entrypoint.strip():
            raise TypeError("entrypoint must be a non-empty string")
        if env_vars is not None and not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env_vars.items()
        ):
            raise TypeError("env_vars must map str -> str")
        if job_id is not None and not isinstance(job_id, str):
            raise TypeError("job_id must be a string")
        job_id = job_id or f"raytpu-job-{uuid.uuid4().hex[:8]}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id!r} already exists")
        log_path = os.path.join(self.log_dir, f"{job_id}.log")
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_JOB_ID"] = job_id
        env.update(env_vars or {})
        info = JobInfo(
            job_id=job_id,
            entrypoint=entrypoint,
            status=JobStatus.PENDING,
            log_path=log_path,
            submitted_at=time.time(),
            metadata=dict(metadata or {}),
        )
        with self._lock:
            self._jobs[job_id] = info
        log_file = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                shlex.split(entrypoint),
                stdout=log_file,
                stderr=subprocess.STDOUT,
                env=env,
                cwd=working_dir,
                start_new_session=True,  # own process group: stop kills children
            )
        except Exception as e:  # noqa: BLE001 - any launch failure (OSError,
            # shlex's ValueError, a bad working_dir's TypeError) lands the
            # registered job in FAILED, never a phantom PENDING entry
            log_file.write(f"failed to launch: {e!r}\n".encode())
            log_file.close()
            info.status = JobStatus.FAILED
            info.finished_at = time.time()
            return job_id
        info.status = JobStatus.RUNNING
        with self._lock:
            self._procs[job_id] = proc
        threading.Thread(
            target=self._watch, args=(job_id, proc, log_file), daemon=True,
            name=f"job-watch-{job_id}",
        ).start()
        return job_id

    def _watch(self, job_id: str, proc: subprocess.Popen, log_file) -> None:
        returncode = proc.wait()
        log_file.close()
        with self._lock:
            info = self._jobs[job_id]
            info.returncode = returncode
            info.finished_at = time.time()
            if info.status != JobStatus.STOPPED:
                info.status = (
                    JobStatus.SUCCEEDED if returncode == 0 else JobStatus.FAILED
                )
            self._procs.pop(job_id, None)

    def status(self, job_id: str) -> JobStatus:
        return self._get(job_id).status

    def info(self, job_id: str) -> JobInfo:
        return self._get(job_id)

    def logs(self, job_id: str) -> str:
        info = self._get(job_id)
        try:
            with open(info.log_path, "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def list(self) -> List[JobInfo]:
        with self._lock:
            return sorted(self._jobs.values(), key=lambda j: j.submitted_at)

    def stop(self, job_id: str, timeout: float = 5.0) -> bool:
        with self._lock:
            proc = self._procs.get(job_id)
            info = self._jobs.get(job_id)
        if proc is None or info is None:
            return False
        info.status = JobStatus.STOPPED
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            return True
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
        return True

    def wait(self, job_id: str, timeout: Optional[float] = None) -> JobStatus:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            status = self.status(job_id)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
                return status
            if deadline is not None and time.monotonic() > deadline:
                return status
            time.sleep(0.05)

    def _get(self, job_id: str) -> JobInfo:
        with self._lock:
            if job_id not in self._jobs:
                raise KeyError(f"no job {job_id!r}")
            return self._jobs[job_id]


_default_manager: Optional[JobManager] = None
_mgr_lock = threading.Lock()


def default_job_manager() -> JobManager:
    global _default_manager
    with _mgr_lock:
        if _default_manager is None:
            _default_manager = JobManager()
        return _default_manager
