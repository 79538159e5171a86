"""Health checking and host memory monitoring (failure detection).

Port of `ray_tpu/core/health.py` for one process:

- `HealthCheckManager`: periodic liveness probes, one plain callable per
  target, with a consecutive-failure threshold. A dead target gets its
  callback once; for a process actor it feeds the restart path, so a
  killed worker process is detected and restarted WITHOUT waiting for the
  next method call (`runtime._register_actor_health`).
- `MemoryMonitor`: when host memory in use crosses the threshold, kill a
  busy pooled worker process so the kernel's OOM killer does not pick
  something load-bearing. `retriable_fifo` kills the newest busy worker
  (its task retries if it may); `group_by_owner` kills from the largest
  group of workers sharing one runtime env.

Both run as daemon threads with flag-controlled periods (`config.py`);
`stop()` joins them. `probe_agent` asks a cluster node's agent for its
`node_info` over RPC (one synchronous liveness probe).
`install_preemption_signal_handler` makes SIGTERM a node agent's
preemption notice (`ClusterContext.begin_preemption`: announce, drain for
the warning window, then shut down gracefully); `cli.py`'s `start`
installs it.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)



class HealthCheckManager:
    """Periodic liveness probes with a consecutive-failure threshold."""

    def __init__(self, period_s: float, failure_threshold: int):
        self.period_s = period_s
        self.failure_threshold = failure_threshold
        # target -> (probe() -> bool, on_dead(target_id))
        self._targets: Dict[str, Tuple[Callable[[], bool], Callable[[str], None]]] = {}
        self._failures: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"probes": 0, "deaths": 0}

    def register(self, target_id: str, probe: Callable[[], bool],
                 on_dead: Callable[[str], None]) -> None:
        with self._lock:
            self._targets[target_id] = (probe, on_dead)
            self._failures[target_id] = 0

    def unregister(self, target_id: str) -> None:
        with self._lock:
            self._targets.pop(target_id, None)
            self._failures.pop(target_id, None)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ray_tpu_torch-health-check"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            self.check_once()

    def check_once(self) -> List[str]:
        """One probe round; returns the targets declared dead this round."""
        with self._lock:
            targets = list(self._targets.items())
        dead: List[str] = []
        for target_id, (probe, on_dead) in targets:
            self.stats["probes"] += 1
            try:
                alive = bool(probe())
            except Exception:  # noqa: BLE001 - a raising probe counts as down
                alive = False
            with self._lock:
                if target_id not in self._targets:
                    continue  # unregistered mid-round
                if alive:
                    self._failures[target_id] = 0
                    continue
                self._failures[target_id] = self._failures.get(target_id, 0) + 1
                if self._failures[target_id] < self.failure_threshold:
                    continue
                # declared dead: unregister so the callback fires once
                self._targets.pop(target_id, None)
                self._failures.pop(target_id, None)
            dead.append(target_id)
            self.stats["deaths"] += 1
            from ..util.events import emit
            from ..util.metrics import get_or_create_counter

            get_or_create_counter(
                "raytpu_health_deaths_total",
                "Targets (process actors, nodes) declared dead by the "
                "health-check manager.",
            ).inc()
            emit("WARNING", "health", f"{target_id} declared dead", kind="health.dead")
            logger.warning("health check: %s declared dead", target_id)
            try:
                on_dead(target_id)
            except Exception:  # noqa: BLE001 - callback bugs must not stop probing
                logger.exception("health-check on_dead callback failed")
        return dead


def probe_agent(node) -> bool:
    """Synchronous liveness probe of a cluster node's agent: its
    `node_info` answered over the agent's RPC address. Local (in-process)
    nodes are trivially alive."""
    if not getattr(node, "is_remote", False):
        return bool(getattr(node, "alive", True))
    client = getattr(node, "client", None)
    if client is None or not node.alive:
        return False
    try:
        return bool(client.call("node_info"))
    except Exception:  # noqa: BLE001 - any transport failure counts as down
        return False


def install_preemption_signal_handler(ctx, warning_s: Optional[float] = None):
    """Make SIGTERM a preemption notice: cloud providers deliver spot and
    maintenance preemptions as SIGTERM with a grace window, so a node agent
    that receives it announces PREEMPTING (`ctx.begin_preemption`: pub/sub,
    node table, local drain) and shuts down gracefully when the window
    closes. Returns the previous handler. Main thread only (the signal
    module's rule): the CLI's agent loop installs it."""
    import signal

    def _on_sigterm(signum, frame):  # noqa: ARG001 - the signal signature
        ctx.begin_preemption("SIGTERM (preemption notice)", warning_s=warning_s,
                             fate="shutdown")

    return signal.signal(signal.SIGTERM, _on_sigterm)


def read_memory_usage_fraction() -> float:
    """Fraction of host memory in use, from /proc/meminfo."""
    total = avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1])
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1])
            if total is not None and avail is not None:
                break
    if not total or avail is None:
        return 0.0
    return 1.0 - avail / total


class MemoryMonitor:
    """Kills pooled worker processes when host memory pressure crosses the
    threshold."""

    def __init__(
        self,
        threshold: float,
        interval_s: float,
        policy: str = "retriable_fifo",
        usage_fn: Callable[[], float] = read_memory_usage_fraction,
    ):
        if policy not in ("retriable_fifo", "group_by_owner"):
            raise ValueError(f"unknown oom policy {policy!r}")
        self.threshold = threshold
        self.interval_s = interval_s
        self.policy = policy
        self.usage_fn = usage_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"checks": 0, "kills": 0}

    def start(self) -> None:
        if self._thread is None and self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ray_tpu_torch-memory-monitor"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_once()

    def check_once(self) -> bool:
        """True if a worker was killed this round."""
        self.stats["checks"] += 1
        try:
            usage = self.usage_fn()
        except Exception:  # noqa: BLE001 - unreadable meminfo = no action
            return False
        if usage < self.threshold:
            return False
        victim = self._pick_victim()
        if victim is None:
            logger.warning("memory usage %.0f%% over threshold but no killable worker",
                           usage * 100)
            return False
        from ..util.events import emit

        emit("ERROR", "health", f"OOM policy killed worker {victim.pid}",
             kind="health.oom", usage=round(usage, 3), policy=self.policy)
        logger.warning(
            "memory usage %.0f%% >= %.0f%%: killing worker %d (%s policy); "
            "its task will retry if retriable",
            usage * 100, self.threshold * 100, victim.pid, self.policy,
        )
        victim.kill()
        self.stats["kills"] += 1
        return True

    def _pick_victim(self):
        from .worker_pool import peek_worker_pool

        pool = peek_worker_pool()
        if pool is None:
            return None
        with pool._lock:
            busy = list(pool._busy)
        if not busy:
            return None
        if self.policy == "retriable_fifo":
            # newest first: the youngest task has the least sunk work
            return max(busy, key=lambda w: w.last_used)
        # group_by_owner: kill from the largest same-environment group so
        # one runaway owner loses capacity before unrelated work does
        groups: Dict[tuple, List] = {}
        for w in busy:
            groups.setdefault(w.env_key, []).append(w)
        largest = max(groups.values(), key=len)
        return max(largest, key=lambda w: w.last_used)
