"""Per-node stats collection: the sampling half of the telemetry plane.

Port of `ray_tpu/core/stats.py`. One collector per process (one process
per node): it samples process CPU and RSS, the object store, the worker
pool's occupancy, task queue depths, and the CUDA devices' memory, and
the cluster heartbeat piggybacks the snapshot into the GCS node table
(core/cluster.py), so the head federates without a second agent.

Where JAX samples each TPU's HBM through ``Device.memory_stats()``
(``sample_tpu_stats``), the port reads each CUDA device's memory through
``torch.cuda`` (``sample_cuda_stats``), and only in a process that
already holds a CUDA context (``torch.cuda.is_initialized()``): a process
worker or a CPU-only agent never creates one for its telemetry.

Everything here is read-only and failure-isolated: a sampler that cannot
read its source returns a degraded snapshot, never raises into the
heartbeat or scrape path.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def sample_process_rss_bytes() -> int:
    """Resident set size of THIS process, from /proc (no psutil)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        try:
            import resource

            # ru_maxrss is KiB on Linux: the peak, not the current size,
            # still a usable degraded signal where /proc is missing
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001 - degraded snapshot over a raise
            return 0


def sample_cuda_stats() -> List[Dict[str, Any]]:
    """Per-device CUDA telemetry: the device's name, the bytes the caching
    allocator holds allocated (peak too) and reserved, the device's total
    memory, and a duty proxy (allocated / total). Guarded three ways:
    torch must ALREADY be imported, this process must already hold a
    CUDA context (`torch.cuda.is_initialized()`: sampling never creates
    one), and a raising query degrades to an empty list."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_initialized():
            return []
        count = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 - no CUDA runtime: no device telemetry
        return []
    out: List[Dict[str, Any]] = []
    for i in range(count):
        try:
            props = torch.cuda.get_device_properties(i)
            allocated = int(torch.cuda.memory_allocated(i))
            rec: Dict[str, Any] = {
                "id": i,
                "kind": props.name,
                "platform": "cuda",
                "memory_allocated_bytes": allocated,
                "memory_peak_allocated_bytes": int(torch.cuda.max_memory_allocated(i)),
                "memory_reserved_bytes": int(torch.cuda.memory_reserved(i)),
                "memory_total_bytes": int(props.total_memory),
            }
        except Exception:  # noqa: BLE001 - degraded snapshot over a raise
            continue
        total = rec["memory_total_bytes"]
        rec["duty"] = round(allocated / total, 4) if total > 0 else 0.0
        out.append(rec)
    return out


class NodeStatsCollector:
    """Samples this node's (process's) runtime internals into one snapshot
    dict. One collector per Runtime; `snapshot()` is cheap enough for the
    heartbeat period and the /metrics scrape."""

    def __init__(self, runtime):
        self._runtime = runtime
        self._lock = threading.Lock()
        # CPU %: the delta of process CPU time over the delta of wall time
        self._last_wall = time.monotonic()  # guarded-by: _lock
        self._last_cpu = self._cpu_seconds()  # guarded-by: _lock
        self._cpu_percent = 0.0  # guarded-by: _lock

    @staticmethod
    def _cpu_seconds() -> float:
        t = os.times()
        return t.user + t.system

    def _sample_cpu_percent(self) -> float:
        now = time.monotonic()
        cpu = self._cpu_seconds()
        with self._lock:
            dw = now - self._last_wall
            if dw >= 0.1:  # samples too close together only amplify noise
                self._cpu_percent = max(0.0, 100.0 * (cpu - self._last_cpu) / dw)
                self._last_wall, self._last_cpu = now, cpu
            return round(self._cpu_percent, 2)

    def _sample_worker_pool(self) -> Dict[str, Any]:
        """Occupancy of the process worker pool WITHOUT spawning it."""
        from . import worker_pool as wp

        pool = wp._pool
        if pool is None:
            return {"busy": 0, "idle": 0, "started": False}
        with pool._lock:
            return {"busy": len(pool._busy), "idle": len(pool._idle), "started": True}

    def _sample_task_queues(self) -> Dict[str, int]:
        sched = self._runtime.scheduler
        cluster = getattr(self._runtime, "cluster", None)
        with sched._lock:
            pending = len(sched._pending)
            blocked = len(sched._blocked)
        admission = 0
        if cluster is not None:
            with cluster._admit_lock:
                admission = len(cluster._admit_queue)
        return {"pending": pending, "blocked": blocked, "admission": admission}

    @staticmethod
    def _sample_profiling() -> Dict[str, Any]:
        from ..util import profiling

        try:
            return profiling.node_snapshot()
        except Exception:  # noqa: BLE001 - degraded snapshot over a raise
            return {}

    @staticmethod
    def _sample_events() -> Dict[str, Any]:
        """Flight-recorder health (util/events): emitted count, ring
        occupancy, the durable segments' state."""
        from ..util.events import events

        try:
            return events().stats()
        except Exception:  # noqa: BLE001 - degraded snapshot over a raise
            return {}

    def snapshot(self) -> Dict[str, Any]:
        """One telemetry snapshot of this node. The keys are JAX's, with
        its TPU block (`tpu`) replaced by the CUDA block (`cuda`): the GCS
        node table and `state.summary()["node_stats"]` carry this shape."""
        rt = self._runtime
        cluster = getattr(rt, "cluster", None)
        snap: Dict[str, Any] = {
            "ts": time.time(),
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "cpu_percent": self._sample_cpu_percent(),
            "rss_bytes": sample_process_rss_bytes(),
            "object_store": dict(rt.object_store.usage()),
            "worker_pool": self._sample_worker_pool(),
            "task_queues": self._sample_task_queues(),
            "scheduler": dict(rt.scheduler.stats),
            "health": dict(rt.health.stats),
            "pubsub": dict(getattr(rt.gcs.pubsub, "stats", {})),
            "cuda": sample_cuda_stats(),
            "profiling": self._sample_profiling(),
            "events": self._sample_events(),
        }
        if cluster is not None:
            snap["agent"] = dict(cluster.agent_stats)
        return snap


def register_node_gauges() -> None:
    """Node-local callback gauges over the collector (sampled at scrape
    time; every callback rides Gauge.collect's sampler-failure guard).
    Idempotent across runtime re-inits."""
    from ..util.metrics import get_or_create_gauge
    from . import runtime as rt

    def collector():
        if not rt.is_initialized():
            return None
        return getattr(rt.get_runtime(), "node_stats", None)

    def cpu_percent():
        c = collector()
        return 0.0 if c is None else float(c._sample_cpu_percent())

    get_or_create_gauge("raytpu_node_cpu_percent",
                        "Process CPU utilization of this node agent, percent.",
                        fn=cpu_percent)
    get_or_create_gauge("raytpu_node_rss_bytes",
                        "Resident set size of this node agent's process.",
                        fn=lambda: float(sample_process_rss_bytes()))

    def worker_pool():
        c = collector()
        if c is None:
            return []
        wp = c._sample_worker_pool()
        return [({"state": "busy"}, float(wp["busy"])),
                ({"state": "idle"}, float(wp["idle"]))]

    get_or_create_gauge("raytpu_node_worker_pool",
                        "Process worker pool occupancy (busy/idle workers).",
                        tag_keys=("state",), fn=worker_pool)

    def task_queues():
        c = collector()
        if c is None:
            return []
        return [({"queue": k}, float(v)) for k, v in c._sample_task_queues().items()]

    get_or_create_gauge("raytpu_node_task_queue_depth",
                        "Task queue depths: scheduler pending/blocked + agent admission.",
                        tag_keys=("queue",), fn=task_queues)

    def cuda_metric(key):
        def sample():
            return [({"device": str(dev["id"])}, float(dev[key]))
                    for dev in sample_cuda_stats() if key in dev]

        return sample

    get_or_create_gauge("raytpu_node_cuda_memory_allocated_bytes",
                        "Per-device CUDA bytes the caching allocator holds allocated.",
                        tag_keys=("device",), fn=cuda_metric("memory_allocated_bytes"))
    get_or_create_gauge("raytpu_node_cuda_memory_reserved_bytes",
                        "Per-device CUDA bytes the caching allocator holds reserved.",
                        tag_keys=("device",), fn=cuda_metric("memory_reserved_bytes"))
    get_or_create_gauge("raytpu_node_cuda_memory_total_bytes",
                        "Per-device CUDA memory capacity.",
                        tag_keys=("device",), fn=cuda_metric("memory_total_bytes"))
    get_or_create_gauge("raytpu_node_cuda_duty",
                        "Per-device duty proxy: fraction of the device's memory allocated.",
                        tag_keys=("device",), fn=cuda_metric("duty"))
