"""Capacity plane: the demand-aggregating, spot-aware cluster autoscaler.

Port of `ray_tpu/core/capacity.py`. Three ideas compose:

1. **Demand aggregation.** A :class:`DemandLedger` reads every pending
   demand the scheduler can see (queued tasks, unplaced placement-group
   bundles, gang-atomic: a group's bundles are planned onto capacity
   launched together, never piecemeal), actors waiting for capacity, and
   registered sources (a train gang's restart, serve replicas that no
   node can host). Each demand carries an *origin*, so a scale-up event
   says why a node exists.

2. **Spot-aware provisioning.** :class:`NodeType` carries a
   ``capacity_class`` (``on_demand`` or ``spot``) with per-class limits;
   :class:`SpotNodeProvider` wraps any provider with a preemption
   schedule (per-node lifetimes, or seeded random ones) that pulls the
   real announced-preemption trigger (PREEMPTING, drain, death). On an
   announcement the autoscaler launches replacement capacity for the
   draining node's resident demand (gang bundles first) at once, inside
   the warning window.

3. **Lifecycle.** Scale-down selects only managed nodes that are idle,
   not PREEMPTING and pinned by no live actor or primary object copy, and
   retires them through the drain path with a grace period; planning
   respects each type's ``max_workers``, the class limits and an optional
   resource budget.

A node type's ``GPU`` resource is what an autoscaled agent advertises:
:class:`LocalProcessNodeProvider` starts ``python -m ray_tpu_torch start``
with ``--num-gpus`` from it (0 where the type has none), so a CPU node type
never advertises the host's cards, and its agent creates no CUDA context.
JAX's provider starts its agents with ``--no-tpu``.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .ids import NodeID
from .resources import ResourceDict, ResourceSet
from .scheduler import ClusterScheduler, Node

CAPACITY_CLASSES = ("on_demand", "spot")

# demand origins the gauges/status always report (a stale tagged series
# would otherwise linger at its last value after the demand drains)
DEMAND_ORIGINS = ("task", "pg", "train", "serve", "replace")


@dataclasses.dataclass
class NodeType:
    """A launchable node shape. ``capacity_class`` tags the economics:
    ``spot`` nodes are expected to be preempted with a warning window;
    the scaler's per-class limits and the SpotNodeProvider key off it."""

    name: str
    resources: ResourceDict
    max_workers: int = 10
    capacity_class: str = "on_demand"


@dataclasses.dataclass
class Demand:
    """One pending demand group. ``bundles`` is the gang-atomic set of
    per-unit resource requests (a singleton list for plain tasks)."""

    bundles: List[ResourceDict]
    origin: str = "task"  # one of DEMAND_ORIGINS
    detail: str = ""
    gang: bool = False


class NodeProvider:
    """Create/terminate nodes. The fake provider materializes logical
    nodes directly in the scheduler; cloud providers would call infra
    APIs behind the same two methods."""

    def create_node(self, node_type: NodeType) -> Node:
        raise NotImplementedError

    def terminate_node(self, node: Node) -> None:
        raise NotImplementedError


def agent_command(gcs_address: str, node_type: NodeType,
                  token: Optional[str] = None) -> List[str]:
    """The command line of an autoscaled agent of `node_type`: its CPUs
    and GPUs from the type's resources (GPU 0 where it has none, so the
    agent never advertises the host's cards), the rest as custom
    resources, and labels that mark it autoscaled."""
    import json
    import sys

    res = dict(node_type.resources)
    num_cpus = int(res.pop("CPU", 1))
    num_gpus = int(res.pop("GPU", 0))
    labels = {
        "node_type": node_type.name,
        "autoscaled": "1",
        "capacity_class": node_type.capacity_class,
    }
    cmd = [
        sys.executable, "-m", "ray_tpu_torch", "start",
        "--address", gcs_address, "--num-cpus", str(num_cpus),
        "--num-gpus", str(num_gpus), "--labels", json.dumps(labels),
    ]
    if res:
        cmd += ["--resources", json.dumps(res)]
    if token:
        cmd += ["--token", token]
    return cmd


class LocalProcessNodeProvider(NodeProvider):
    """Autoscale with real nodes: each create_node spawns a node-agent
    process (`python -m ray_tpu_torch start --address=...`) that joins the
    cluster, and terminate_node shuts it down gracefully. What an agent
    runs is pickled by reference, so it gets this process's `sys.path[0]`
    first on its PYTHONPATH, as `cluster_utils.Cluster`'s agents do. Each
    agent logs to a temporary file, removed when the agent is reaped."""

    def __init__(self, runtime, startup_timeout_s: float = 60.0):
        if runtime.cluster is None:
            raise ValueError(
                "LocalProcessNodeProvider needs a cluster runtime "
                "(init(head=True)): agents must have a GCS to join"
            )
        self.runtime = runtime
        self.startup_timeout_s = startup_timeout_s
        self._lock = threading.Lock()
        self._procs: Dict[str, Any] = {}  # node id hex -> Popen  # guarded-by: _lock
        # agents spawned but not joined yet: shutdown() kills them too, so
        # a launch in flight when the autoscaler stops leaves no orphan
        self._starting: Dict[int, Any] = {}  # pid -> Popen  # guarded-by: _lock
        self._logs: Dict[int, str] = {}  # pid -> log path  # guarded-by: _lock

    def create_node(self, node_type: NodeType) -> Node:
        import os
        import subprocess
        import sys
        import tempfile

        ctx = self.runtime.cluster
        before = {n.node_id.hex() for n in self.runtime.scheduler.nodes()}
        cmd = agent_command(ctx.gcs_address, node_type, ctx.token)
        env = dict(os.environ)
        first = os.path.abspath(sys.path[0] or os.getcwd())
        paths = [first] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
        fd, log_path = tempfile.mkstemp(prefix="ray_tpu_torch_autoscaled_", suffix=".log")
        with os.fdopen(fd, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
        with self._lock:
            self._logs[proc.pid] = log_path
            self._starting[proc.pid] = proc
        try:
            return self._await_join(proc, before)
        finally:
            with self._lock:
                self._starting.pop(proc.pid, None)

    def _await_join(self, proc, before) -> Node:
        """The agent's node once it joined this scheduler's view; raises
        (and reaps the agent) when it exits first or the timeout passes."""
        deadline = time.monotonic() + self.startup_timeout_s
        while time.monotonic() < deadline:
            for node in self.runtime.scheduler.nodes():
                hex_id = node.node_id.hex()
                if (hex_id not in before and node.labels.get("autoscaled") == "1"
                        and getattr(node, "pid", None) == proc.pid):
                    with self._lock:
                        self._procs[hex_id] = proc
                    return node
            if proc.poll() is not None:
                tail = self._reap(proc)
                raise RuntimeError(
                    f"autoscaled agent exited rc={proc.returncode} before joining; "
                    f"its log's tail:\n{tail}")
            time.sleep(0.05)
        proc.kill()
        tail = self._reap(proc)
        raise TimeoutError(f"autoscaled agent did not join in time; its log's tail:\n{tail}")

    def _reap(self, proc) -> str:
        """Wait for an agent that exited or was killed, remove its log and
        return the log's last lines."""
        import os

        proc.wait()
        with self._lock:
            path = self._logs.pop(proc.pid, None)
        if path is None:
            return ""
        try:
            with open(path, errors="replace") as f:
                tail = "\n".join(f.read().splitlines()[-30:])
            os.unlink(path)
        except OSError:
            tail = ""
        return tail

    def pids(self) -> List[int]:
        """The pids of the agents this provider started and has not reaped."""
        with self._lock:
            return [p.pid for p in self._procs.values()]

    def terminate_node(self, node: Node) -> None:
        import subprocess

        with self._lock:
            proc = self._procs.pop(node.node_id.hex(), None)
        try:
            node.client.call("shutdown_node")  # graceful: the agent deregisters
        except Exception:  # noqa: BLE001 - a dead agent is terminated all the same
            pass
        if proc is not None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
            self._reap(proc)
        self.runtime.scheduler.remove_node(node.node_id)

    def shutdown(self) -> None:
        with self._lock:
            procs = list(self._procs.values()) + list(self._starting.values())
            self._procs.clear()
            self._starting.clear()
        for proc in procs:
            proc.kill()
            self._reap(proc)


class FakeNodeProvider(NodeProvider):
    """Logical nodes made directly in this process's scheduler."""

    def __init__(self, scheduler: ClusterScheduler):
        self.scheduler = scheduler
        self.created: List[Node] = []

    def create_node(self, node_type: NodeType) -> Node:
        node = Node(
            NodeID.from_random(),
            dict(node_type.resources),
            is_head=False,
            labels={
                "node_type": node_type.name,
                "autoscaled": "1",
                "capacity_class": node_type.capacity_class,
            },
        )
        self.scheduler.add_node(node)
        self.created.append(node)
        return node

    def terminate_node(self, node: Node) -> None:
        self.scheduler.remove_node(node.node_id)


class SpotNodeProvider(NodeProvider):
    """Wrap any provider with spot semantics: every created node is
    labeled ``capacity_class=spot`` and lives on a preemption schedule.
    When a node's lifetime expires the provider pulls the REAL
    announced-preemption trigger (chaos.trigger_preemption → the
    runtime's hook → PREEMPTING → pubsub announcement → drain window →
    kill), so everything downstream — train emergency checkpoints, serve
    drains, the scaler's pre-provisioned replacements — rehearses the
    exact production path.

    ``schedule`` is a list of per-created-node entries, in creation
    order: ``(lifetime_s, warning_s)``, a bare lifetime (the default
    warning window applies), or ``None`` (that node is never reclaimed).
    Nodes beyond the schedule draw seeded-random exponential lifetimes
    when ``mean_lifetime_s`` > 0, else live forever. ``preempt_after``
    arms a reclaim deterministically — drills use it to tie the
    announcement to a causal point (e.g. "training reported a step")."""

    def __init__(self, inner: NodeProvider, *,
                 schedule: Optional[Sequence[Any]] = None,
                 mean_lifetime_s: float = 0.0,
                 warning_s: Optional[float] = None,
                 seed: int = 0):
        self.inner = inner
        self.schedule = list(schedule or [])
        self.mean_lifetime_s = mean_lifetime_s
        self._warning_override = warning_s
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._created = 0  # guarded-by: _lock
        self._timers: Dict[str, threading.Timer] = {}  # guarded-by: _lock
        self.preemptions: List[Dict[str, Any]] = []  # guarded-by: _lock

    def default_warning_s(self) -> float:
        if self._warning_override is not None:
            return self._warning_override
        from .config import cfg

        return cfg.spot_preempt_warning_s

    def create_node(self, node_type: NodeType) -> Node:
        node = self.inner.create_node(node_type)
        node.labels["capacity_class"] = "spot"
        with self._lock:
            index = self._created
            self._created += 1
        lifetime, warning = self._plan_for(index)
        if lifetime is not None and lifetime > 0:
            self.preempt_after(node, lifetime, warning)
        return node

    def _plan_for(self, index: int) -> Tuple[Optional[float], Optional[float]]:
        if index < len(self.schedule):
            item = self.schedule[index]
            if item is None:
                return None, None
            if isinstance(item, (tuple, list)):
                lifetime, warning = item
                return float(lifetime), float(warning)
            return float(item), None
        if self.mean_lifetime_s > 0:
            return self._rng.expovariate(1.0 / self.mean_lifetime_s), None
        return None, None

    def preempt_after(self, node: Node, delay_s: float,
                      warning_s: Optional[float] = None) -> None:
        """Arm (or re-arm) the reclaim timer for a node."""
        if warning_s is None:
            warning_s = self.default_warning_s()
        timer = threading.Timer(
            delay_s, self._reclaim, args=(node, warning_s)
        )
        timer.daemon = True
        with self._lock:
            old = self._timers.get(node.node_id.hex())
            self._timers[node.node_id.hex()] = timer
        if old is not None:
            old.cancel()
        timer.start()

    def _reclaim(self, node: Node, warning_s: float) -> None:
        if not node.alive:
            return
        from . import chaos

        delivered = chaos.trigger_preemption(
            node, warning_s,
            f"spot reclaim of node {node.node_id.hex()[:12]}",
        )
        record = {
            "node": node.node_id.hex(),
            "warning_s": warning_s,
            "ts": time.time(),
            "delivered": delivered,
        }
        with self._lock:
            self.preemptions.append(record)

    def num_preemptions(self) -> int:
        with self._lock:
            return len(self.preemptions)

    def terminate_node(self, node: Node) -> None:
        with self._lock:
            timer = self._timers.pop(node.node_id.hex(), None)
        if timer is not None:
            timer.cancel()
        self.inner.terminate_node(node)

    def shutdown(self) -> None:
        with self._lock:
            timers = list(self._timers.values())
            self._timers.clear()
        for timer in timers:
            timer.cancel()
        inner_shutdown = getattr(self.inner, "shutdown", None)
        if inner_shutdown is not None:
            inner_shutdown()


# ------------------------------------------------------- demand aggregation

# External demand sources (train controllers, serve controllers, ...)
# registered by name. Each callable returns a list of Demand objects or
# plain dicts {"bundles": [...], "origin": ..., "detail": ..., "gang": ...}.
_sources_lock = threading.Lock()
_demand_sources: Dict[str, Callable[[], List[Any]]] = {}


def register_demand_source(name: str, fn: Callable[[], List[Any]]) -> None:
    """Register a pending-demand callable under `name` (idempotent
    overwrite). Sources are polled by every DemandLedger.collect()."""
    with _sources_lock:
        _demand_sources[name] = fn


def unregister_demand_source(name: str) -> None:
    with _sources_lock:
        _demand_sources.pop(name, None)


# Actors whose placement loop found no live node that can EVER fit them
# but an active capacity plane said it can provision one: they wait
# instead of dying, and their demand lands here so the ledger sees it.
_waiting_actors_lock = threading.Lock()
_waiting_actors: Dict[int, Tuple[ResourceDict, str]] = {}  # guarded-by: _waiting_actors_lock


def note_actor_waiting(key: int, resources: ResourceDict,
                       detail: str = "") -> None:
    with _waiting_actors_lock:
        _waiting_actors[key] = (dict(resources), detail)


def clear_actor_waiting(key: int) -> None:
    with _waiting_actors_lock:
        _waiting_actors.pop(key, None)


def waiting_actor_demand() -> List["Demand"]:
    with _waiting_actors_lock:
        entries = list(_waiting_actors.values())
    return [Demand(bundles=[dict(res)], origin="task", detail=detail)
            for res, detail in entries]


def _bundle_sig(bundles: Sequence[ResourceDict]) -> Tuple:
    return tuple(sorted(tuple(sorted(r.items())) for r in bundles))


def _normalize_demand(item: Any, default_origin: str) -> Optional[Demand]:
    if isinstance(item, Demand):
        return item if item.bundles else None
    if isinstance(item, dict):
        bundles = [dict(r) for r in item.get("bundles") or []]
        if not bundles:
            return None
        return Demand(
            bundles=bundles,
            origin=str(item.get("origin") or default_origin),
            detail=str(item.get("detail") or ""),
            gang=bool(item.get("gang")),
        )
    return None


class DemandLedger:
    """Aggregates every pending demand the capacity plane acts on:
    queued tasks and unplaceable PG gangs from the scheduler, plus
    registered external sources. Train-origin gang demands whose bundle
    multiset already appears as a queued PG gang are dropped — the PG is
    the authoritative record once the restart reaches reservation."""

    def __init__(self, scheduler: ClusterScheduler):
        self.scheduler = scheduler
        self._warned_sources: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()

    # demand aggregation, not a metrics Gauge.collect override
    def collect(self) -> List[Demand]:  # raylint: disable=metrics-names
        demands: List[Demand] = []
        for res in self.scheduler.pending_task_demand():
            demands.append(Demand(bundles=[res], origin="task"))
        demands.extend(waiting_actor_demand())
        gang_sigs = set()
        for gang in self.scheduler.pending_gang_demand():
            demands.append(Demand(
                bundles=[dict(r) for r in gang["bundles"]],
                origin="pg",
                detail=gang["name"] or gang["pg"][:12],
                gang=True,
            ))
            gang_sigs.add(_bundle_sig(gang["bundles"]))
        with _sources_lock:
            sources = list(_demand_sources.items())
        for name, fn in sources:
            try:
                items = fn() or []
            except Exception as exc:  # noqa: BLE001 - one broken source must not blind the plane
                self._warn_source(name, exc)
                continue
            for item in items:
                demand = _normalize_demand(item, name.split(":", 1)[0])
                if demand is None:
                    continue
                if (demand.origin == "train"
                        and _bundle_sig(demand.bundles) in gang_sigs):
                    continue
                demands.append(demand)
        return demands

    def _warn_source(self, name: str, exc: BaseException) -> None:
        with self._lock:
            first = name not in self._warned_sources
            self._warned_sources.add(name)
        if first:
            from ..util.events import emit

            emit("WARNING", "autoscaler",
                 f"demand source {name!r} raised and is being skipped: "
                 f"{exc!r}", kind="autoscaler.error", source_name=name,
                 error_type=type(exc).__name__)

    @staticmethod
    def by_origin(demands: Sequence[Demand]) -> Dict[str, int]:
        counts = {origin: 0 for origin in DEMAND_ORIGINS}
        for d in demands:
            counts[d.origin] = counts.get(d.origin, 0) + 1
        return counts


# ------------------------------------------------------------ the autoscaler

# Active scaler registry so the status plane (util/state, dashboard, CLI)
# can find the running instance without threading it everywhere.
_active_lock = threading.Lock()
_active_scalers: List["CapacityAutoscaler"] = []


def active_autoscaler() -> Optional["CapacityAutoscaler"]:
    with _active_lock:
        return _active_scalers[-1] if _active_scalers else None


class CapacityAutoscaler:
    """Poll loop closing the cluster control loop: aggregate demand →
    launch nodes (gang-atomic bin-packing, class limits, budget);
    preemption announcements → pre-provisioned replacements; idle
    managed nodes → drain-path retirement after idle_timeout."""

    def __init__(
        self,
        scheduler: ClusterScheduler,
        provider: NodeProvider,
        node_types: List[NodeType],
        *,
        poll_interval_s: float = 0.1,
        idle_timeout_s: float = 5.0,
        drain_grace_s: Optional[float] = None,
        runtime=None,
        class_limits: Optional[Dict[str, int]] = None,
        resource_budget: Optional[ResourceDict] = None,
    ):
        self.scheduler = scheduler
        self.provider = provider
        self.node_types = node_types
        self.poll_interval_s = poll_interval_s
        self.idle_timeout_s = idle_timeout_s
        if drain_grace_s is None:
            from .config import cfg

            drain_grace_s = cfg.autoscaler_drain_grace_s
        self.drain_grace_s = drain_grace_s
        self.runtime = runtime
        self.class_limits = dict(class_limits or {})
        self.resource_budget = dict(resource_budget) if resource_budget else None
        self.ledger = DemandLedger(scheduler)
        self._lock = threading.Lock()
        self._managed: Dict[str, Node] = {}  # guarded-by: _lock
        self._idle_since: Dict[str, float] = {}  # guarded-by: _lock
        self._retiring: Dict[str, float] = {}  # guarded-by: _lock
        self._per_type_count: Dict[str, int] = {t.name: 0 for t in node_types}  # guarded-by: _lock
        self._per_class_count: Dict[str, int] = {}  # guarded-by: _lock
        self._replaced: set = set()  # guarded-by: _lock
        self._error_types: set = set()  # guarded-by: _lock
        self._blocked_seen: set = set()  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._unsubscribe: Optional[Callable[[], None]] = None
        # read-mostly snapshots for status(); written only by the loop
        self._last_pending = 0
        self._last_by_origin: Dict[str, int] = {}
        self.stats = {
            "scale_ups": 0, "scale_downs": 0, "replacements": 0,
            "blocked": 0, "loop_errors": 0,
        }

    # ------------------------------------------------------------------ loop

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            # infeasible demand now means "provision", not "error"
            self.scheduler.fail_fast_infeasible = False
            self._stop.clear()
            self._subscribe_preemption()
            with _active_lock:
                if self not in _active_scalers:
                    _active_scalers.append(self)
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="autoscaler"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self._unsubscribe is not None:
            try:
                self._unsubscribe()
            except Exception:
                pass
            self._unsubscribe = None
        with _active_lock:
            if self in _active_scalers:
                _active_scalers.remove(self)
        self.scheduler.fail_fast_infeasible = True

    def _subscribe_preemption(self) -> None:
        """Listen for announced preemptions so replacements launch
        INSIDE the warning window (no-op without a runtime handle)."""
        if self.runtime is None or self._unsubscribe is not None:
            return
        from .gcs import PREEMPT_CHANNEL

        pubsub = self.runtime.gcs.pubsub
        pubsub.subscribe(PREEMPT_CHANNEL, self._on_preempt)
        self._unsubscribe = lambda: pubsub.unsubscribe(
            PREEMPT_CHANNEL, self._on_preempt
        )

    def _loop(self) -> None:
        from .runtime import head_outage_s

        while not self._stop.wait(self.poll_interval_s):
            if head_outage_s() > 0.0:
                # head outage: the demand/membership view is frozen at
                # the moment the head went away — launching or scaling
                # down real capacity on a blind control plane would
                # thrash the fleet. Skip ticks until it reconnects.
                self.stats["degraded_skips"] = (
                    self.stats.get("degraded_skips", 0) + 1)
                continue
            try:
                self.step()
            except Exception as exc:  # noqa: BLE001 - the loop must survive, loudly
                self._note_loop_error(exc)

    def _note_loop_error(self, exc: BaseException) -> None:
        """Satellite fix for the seed's silent `except Exception: pass`:
        count every loop error, emit ONE WARNING event per exception
        type so a wedged control loop is visible without flooding."""
        from ..util.events import emit
        from ..util.metrics import get_or_create_counter

        error_type = type(exc).__name__
        with self._lock:
            first = error_type not in self._error_types
            self._error_types.add(error_type)
        self.stats["loop_errors"] += 1
        get_or_create_counter(
            "raytpu_autoscaler_loop_errors_total",
            "Exceptions raised inside the autoscaler poll loop.",
        ).inc()
        if first:
            emit("WARNING", "autoscaler",
                 f"autoscaler loop error ({error_type}): {exc}",
                 kind="autoscaler.error", error_type=error_type)

    # ---------------------------------------------------------------- policy

    def step(self) -> None:
        demands = self.ledger.collect()
        unmet = [d for d in demands if not self._covered(d)]
        launches, blocked = self._plan_launches(unmet)
        for node_type, demand in launches:
            self._launch(node_type, demand)
        for demand in blocked:
            self._note_blocked(demand, "no node type fits within limits/budget")
        self._scale_down()
        # demand that NO node and NO node type can ever cover must fail
        # loudly, not queue forever (fail_fast_infeasible is off while we
        # run, so the scheduler defers that judgment to us)
        self.scheduler.fail_unprovisionable(self._can_ever_provision)
        self._last_pending = len(demands)
        self._last_by_origin = DemandLedger.by_origin(demands)
        self._update_gauges()

    def can_provision(self, demand: ResourceDict) -> bool:
        """Whether some live node or registered node type could ever
        host `demand` — the actor placement loop asks this before
        declaring an actor unschedulable (core/actors.py)."""
        return self._can_ever_provision(demand)

    def _can_ever_provision(self, demand: ResourceDict) -> bool:
        if self._fits_on_some_node(demand):
            return True
        return any(
            all(t.resources.get(k, 0.0) >= v for k, v in demand.items())
            for t in self.node_types  # max_workers ignored: slots free up
        )

    def _fits_on_some_node(self, demand: ResourceDict) -> bool:
        for node in self.scheduler.nodes():
            if not node.alive:
                continue
            total = node.resources.total
            if all(total.get(k, 0.0) >= v for k, v in demand.items()):
                return True
        return False

    def _covered(self, demand: Demand) -> bool:
        """Whether the WHOLE gang fits simultaneously on placeable
        nodes' totals (running work frees up; PREEMPTING nodes never
        count — their capacity is already dead)."""
        pools = [
            dict(n.resources.total)
            for n in self.scheduler.nodes() if n.placeable()
        ]
        return _fit_bundles(demand.bundles, pools)

    def _pick_type(self, res: ResourceDict, type_count: Dict[str, int],
                   class_count: Dict[str, int]) -> Optional[NodeType]:
        for t in self.node_types:
            if type_count.get(t.name, 0) >= t.max_workers:
                continue
            limit = self.class_limits.get(t.capacity_class)
            if limit is not None and class_count.get(t.capacity_class, 0) >= limit:
                continue
            if self._budget_blocks(t, type_count):
                continue
            if all(t.resources.get(k, 0.0) >= v for k, v in res.items()):
                return t
        return None

    def _budget_blocks(self, node_type: NodeType,
                       type_count: Dict[str, int]) -> bool:
        if self.resource_budget is None:
            return False
        totals: ResourceDict = {}
        for t in self.node_types:
            n = type_count.get(t.name, 0) + (1 if t.name == node_type.name else 0)
            for k, v in t.resources.items():
                totals[k] = totals.get(k, 0.0) + n * v
        return any(
            totals.get(k, 0.0) > v + 1e-9
            for k, v in self.resource_budget.items()
        )

    def _plan_launches(
        self, unmet: Sequence[Demand]
    ) -> Tuple[List[Tuple[NodeType, Demand]], List[Demand]]:
        """Gang-atomic bin-packing of unmet demand into launch decisions.
        Each gang either lands whole — across planned pools and newly
        staged nodes — or is reported blocked; no partial gang launches."""
        with self._lock:
            type_count = dict(self._per_type_count)
            class_count = dict(self._per_class_count)
        pools: List[ResourceSet] = []
        launches: List[Tuple[NodeType, Demand]] = []
        blocked: List[Demand] = []
        for demand in unmet:
            staged_acquired: List[Tuple[ResourceSet, ResourceDict]] = []
            staged_nodes: List[Tuple[NodeType, ResourceSet]] = []
            ok = True
            for res in sorted(demand.bundles, key=lambda r: -sum(r.values())):
                placed = False
                for pool in pools + [p for _, p in staged_nodes]:
                    if pool.try_acquire(res):
                        staged_acquired.append((pool, res))
                        placed = True
                        break
                if placed:
                    continue
                node_type = self._pick_type(res, type_count, class_count)
                if node_type is None:
                    ok = False
                    break
                pool = ResourceSet(dict(node_type.resources))
                pool.try_acquire(res)
                staged_acquired.append((pool, res))
                staged_nodes.append((node_type, pool))
                type_count[node_type.name] = type_count.get(node_type.name, 0) + 1
                cls = node_type.capacity_class
                class_count[cls] = class_count.get(cls, 0) + 1
            if ok:
                for node_type, pool in staged_nodes:
                    launches.append((node_type, demand))
                    pools.append(pool)
            else:
                for pool, res in staged_acquired:
                    pool.release(res)
                for node_type, _pool in staged_nodes:
                    type_count[node_type.name] -= 1
                    class_count[node_type.capacity_class] -= 1
                blocked.append(demand)
        return launches, blocked

    def _launch(self, node_type: NodeType, demand: Demand,
                replace_for: str = "") -> Optional[Node]:
        from ..util.events import emit
        from ..util.metrics import get_or_create_counter

        try:
            node = self.provider.create_node(node_type)
        except Exception as exc:  # noqa: BLE001 - a failed launch must not kill the loop
            self._note_loop_error(exc)
            return None
        hex_id = node.node_id.hex()
        node.labels.setdefault("capacity_class", node_type.capacity_class)
        cls = node.labels.get("capacity_class", node_type.capacity_class)
        with self._lock:
            self._managed[hex_id] = node
            # idle clock starts at LAUNCH: a fresh node must get the full
            # idle_timeout to receive the demand it was launched for
            # before scale-down may look at it
            self._idle_since[hex_id] = time.monotonic()
            self._per_type_count[node_type.name] = (
                self._per_type_count.get(node_type.name, 0) + 1
            )
            self._per_class_count[cls] = self._per_class_count.get(cls, 0) + 1
        if replace_for:
            self.stats["replacements"] += 1
            emit("INFO", "autoscaler",
                 f"pre-provisioned {node_type.name} node {hex_id[:12]} "
                 f"replacing preempting node {replace_for[:12]} "
                 f"(origin={demand.origin})",
                 kind="autoscaler.replace", node=hex_id,
                 replaces=replace_for, node_type=node_type.name,
                 capacity_class=cls, origin=demand.origin,
                 detail=demand.detail)
            get_or_create_counter(
                "raytpu_autoscaler_preempt_replacements_total",
                "Replacement nodes pre-provisioned on preemption "
                "announcements.",
            ).inc()
        else:
            self.stats["scale_ups"] += 1
            emit("INFO", "autoscaler",
                 f"launched {node_type.name} node {hex_id[:12]} for "
                 f"{demand.origin} demand"
                 + (f" ({demand.detail})" if demand.detail else ""),
                 kind="autoscaler.scale_up", node=hex_id,
                 node_type=node_type.name, capacity_class=cls,
                 origin=demand.origin, detail=demand.detail)
        get_or_create_counter(
            "raytpu_autoscaler_scale_total",
            "Autoscaler scale actions by direction.",
            ("direction",),
        ).inc(tags={"direction": "up"})
        return node

    def _note_blocked(self, demand: Demand, reason: str) -> None:
        from ..util.events import emit

        signature = (demand.origin, demand.detail, reason)
        with self._lock:
            first = signature not in self._blocked_seen
            self._blocked_seen.add(signature)
        self.stats["blocked"] += 1
        if first:
            emit("WARNING", "autoscaler",
                 f"cannot provision {demand.origin} demand "
                 f"{demand.bundles}: {reason}",
                 kind="autoscaler.blocked", origin=demand.origin,
                 detail=demand.detail, reason=reason)

    # ------------------------------------------------------------ scale-down

    def _node_is_idle(self, node: Node) -> bool:
        with node._lock:
            busy = bool(node.running_tasks)
        avail = node.resources.available()
        total = node.resources.total
        fully_free = all(abs(avail.get(k, 0.0) - v) < 1e-9 for k, v in total.items())
        return not busy and fully_free

    def _node_pinned(self, node: Node) -> bool:
        """Live actors or primary object copies pin a node: terminating
        it would kill state scale-down has no business destroying."""
        if self.runtime is None:
            return False
        try:
            return self.runtime.node_pinned(node)
        except Exception as exc:  # noqa: BLE001 - fail safe: an error pins the node
            self._note_loop_error(exc)
            return True

    def _begin_retirement(self, hex_id: str, node: Node, reason: str) -> None:
        """Retire through the DRAIN path: mark PREEMPTING-style draining
        so nothing new lands, then terminate once idle (or force at the
        grace deadline)."""
        self.scheduler.mark_node_draining(
            hex_id, reason, deadline=time.time() + self.drain_grace_s
        )
        with self._lock:
            self._retiring[hex_id] = time.monotonic() + self.drain_grace_s

    def _scale_down(self) -> None:
        now = time.monotonic()
        with self._lock:
            managed = list(self._managed.items())
            retiring = dict(self._retiring)
        for hex_id, node in managed:
            if not node.alive:
                # died mid-drain (or externally): reconcile bookkeeping
                self._forget(hex_id, node)
                continue
            if hex_id in retiring:
                if self._node_is_idle(node):
                    self._terminate(hex_id, node, "drain complete", forced=False)
                elif now >= retiring[hex_id]:
                    self._terminate(hex_id, node, "drain grace expired", forced=True)
                continue
            if node.draining:
                # PREEMPTING (announced elsewhere): never select it —
                # the preemption path owns its fate
                with self._lock:
                    self._idle_since.pop(hex_id, None)
                continue
            if self._node_pinned(node):
                with self._lock:
                    self._idle_since.pop(hex_id, None)
                continue
            if self._node_is_idle(node):
                with self._lock:
                    since = self._idle_since.setdefault(hex_id, now)
                if now - since >= self.idle_timeout_s:
                    self._begin_retirement(
                        hex_id, node, "autoscaler: idle scale-down"
                    )
            else:
                with self._lock:
                    self._idle_since.pop(hex_id, None)

    def _terminate(self, hex_id: str, node: Node, reason: str,
                   forced: bool) -> None:
        from ..util.events import emit
        from ..util.metrics import get_or_create_counter

        try:
            self.provider.terminate_node(node)
        except Exception as exc:  # noqa: BLE001 - retry next poll, bookkeeping intact
            self._note_loop_error(exc)
            return
        self._forget(hex_id, node)
        self.stats["scale_downs"] += 1
        emit("INFO", "autoscaler",
             f"retired node {hex_id[:12]} through drain path ({reason})",
             kind="autoscaler.scale_down", node=hex_id, reason=reason,
             forced=forced, direction="down")
        get_or_create_counter(
            "raytpu_autoscaler_scale_total",
            "Autoscaler scale actions by direction.",
            ("direction",),
        ).inc(tags={"direction": "down"})

    def _forget(self, hex_id: str, node: Node) -> None:
        """Drop a node from every managed table (idle clocks survive a
        node dying mid-drain because everything keys off hex_id and is
        reconciled here, never left dangling)."""
        node_type = node.labels.get("node_type")
        cls = node.labels.get("capacity_class")
        with self._lock:
            if self._managed.pop(hex_id, None) is None:
                return
            self._idle_since.pop(hex_id, None)
            self._retiring.pop(hex_id, None)
            if node_type in self._per_type_count:
                self._per_type_count[node_type] -= 1
            if cls in self._per_class_count:
                self._per_class_count[cls] -= 1

    # ------------------------------------------------- preemption replacement

    def _on_preempt(self, msg: Any) -> None:
        if not isinstance(msg, dict) or not msg.get("node_hex"):
            return
        try:
            self._replace_preempted(str(msg["node_hex"]))
        except Exception as exc:  # noqa: BLE001 - a pubsub callback must not raise
            self._note_loop_error(exc)

    def _replace_preempted(self, node_hex: str) -> None:
        """A preemption was ANNOUNCED: pre-provision replacement capacity
        for the draining node's resident demand (gang bundles first) NOW,
        inside the warning window, instead of waiting for the death to
        re-queue everything."""
        with self._lock:
            if node_hex in self._replaced:
                return
            self._replaced.add(node_hex)
            our_retirement = node_hex in self._retiring
        if our_retirement:
            return  # our own idle retirement drains too: nothing to replace
        node = next(
            (n for n in self.scheduler.nodes()
             if n.node_id.hex() == node_hex), None
        )
        if node is None:
            return
        demands = self._resident_demand(node)
        if not demands:
            return  # idle spot node reclaimed: demand-driven scale-up covers the future
        launches, blocked = self._plan_launches(demands)
        for node_type, demand in launches:
            self._launch(node_type, demand, replace_for=node_hex)
        for demand in blocked:
            self._note_blocked(demand, "replacement capacity unavailable")

    def _resident_demand(self, node: Node) -> List[Demand]:
        """What the draining node is hosting, as demand groups: each
        RESERVED placement group's resident bundles as one gang-atomic
        demand, plus the remaining in-use resources (tasks, actors) as
        one loose bundle."""
        node_hex = node.node_id.hex()
        demands: List[Demand] = []
        gang_total: ResourceDict = {}
        for bundles in self.scheduler.resident_bundles(node_hex):
            demands.append(Demand(
                bundles=bundles, origin="replace",
                detail=f"gang bundles from {node_hex[:12]}", gang=True,
            ))
            for res in bundles:
                for k, v in res.items():
                    gang_total[k] = gang_total.get(k, 0.0) + v
        total = node.resources.total
        avail = node.resources.available()
        loose = {
            k: total.get(k, 0.0) - avail.get(k, 0.0) - gang_total.get(k, 0.0)
            for k in total
        }
        loose = {k: v for k, v in loose.items() if v > 1e-9}
        if loose:
            demands.append(Demand(
                bundles=[loose], origin="replace",
                detail=f"resident tasks/actors on {node_hex[:12]}",
            ))
        return demands

    # ---------------------------------------------------------- observability

    def _update_gauges(self) -> None:
        from ..util.metrics import get_or_create_gauge

        with self._lock:
            managed = len(self._managed)
        get_or_create_gauge(
            "raytpu_autoscaler_managed_nodes",
            "Nodes currently managed by the capacity plane.",
        ).set(float(managed))
        pending = get_or_create_gauge(
            "raytpu_autoscaler_pending_demands",
            "Pending demand groups the capacity plane sees, by origin.",
            ("origin",),
        )
        for origin in DEMAND_ORIGINS:
            pending.set(float(self._last_by_origin.get(origin, 0)),
                        tags={"origin": origin})

    def status(self) -> Dict[str, object]:
        with self._lock:
            managed = len(self._managed)
            per_type = dict(self._per_type_count)
            per_class = dict(self._per_class_count)
            retiring = len(self._retiring)
        return {
            "managed_nodes": managed,
            "per_type": per_type,
            "per_class": per_class,
            "retiring": retiring,
            "pending_demands": self._last_pending,
            "pending_by_origin": dict(self._last_by_origin),
            **self.stats,
        }


def _fit_bundles(bundles: Sequence[ResourceDict],
                 pools: List[ResourceDict]) -> bool:
    """Greedy largest-first feasibility check: can every bundle land
    simultaneously across the given resource pools (mutated in place)."""
    for res in sorted(bundles, key=lambda r: -sum(r.values())):
        placed = False
        for pool in pools:
            if all(pool.get(k, 0.0) >= v for k, v in res.items()):
                for k, v in res.items():
                    pool[k] = pool.get(k, 0.0) - v
                placed = True
                break
        if not placed:
            return False
    return True
