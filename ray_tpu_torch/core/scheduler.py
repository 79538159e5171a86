"""Task specs, logical nodes, placement groups and the scheduler.

Port of `ray_tpu/core/scheduler.py` for the nodes of one process
(`init(num_nodes=N)` makes N logical nodes, each with its own resource
pool — the reference's multi-node-without-a-cluster trick for tests).
Tasks run on pooled threads: a task occupying resources gets a dedicated
thread, reused across tasks, so a blocking `get` inside a task cannot
deadlock the pool; concurrency is gated by resources, not thread count.

Policy: hybrid (pack onto busy-but-below-threshold nodes, else spread to
the emptiest), "SPREAD", node affinity (hard or soft), node labels (hard
filter, soft preference) and placement groups (PACK / SPREAD /
STRICT_PACK / STRICT_SPREAD, reserved all-or-nothing), and a task's
`locality_hint` (a soft preference for one node, the data plane's block
affinity). Retries re-submit a failed task up to `max_retries` when
`retry_exceptions` allows; a streaming task with `stream_max_backlog`
blocks while its consumer lags that many items behind. A task with
`executor="process"` runs on a pooled worker process
(`worker_pool.execute_process_task`); its thread holds the task's
resources while the worker runs it.

In a cluster (`core/cluster.py`) the scheduler also holds a
`RemoteNode` per joined node agent: a task placed there goes to the
`remote_dispatcher` hook, which ships it over RPC, and completes through
`finish_remote` (or is bounced back by a full agent, `requeue_remote`).
A dead node's tasks resubmit under `cfg.system_failure_retries`
(`handle_node_death`), budgeted apart from `max_retries`. The default
policy prefers a feasible node already holding a task's large remote
arguments (argument locality). A task whose function a peer could not
import (`worker_pool.check_importable`: the port pickles by reference) is
`local_only`: feasible only on this process's nodes.

Placement groups reach node agents through a two-phase commit: phase 1
acquires every bundle on this process's view of its node under the lock,
phase 2 asks each remote bundle's agent to reserve against its own
ledger (`remote_bundle_reserver`); a refusal rolls the group back and
replans. A group moves PENDING -> RESERVED; a bundle host's death moves
it to RESCHEDULING, and a rescheduler thread re-runs the commit for the
dead bundles on surviving nodes (logical or agents) under a budget
(`max_reschedules`, default `cfg.pg_reschedule_budget`) with backoff:
back to RESERVED, or FAILED with the death history once the budget is
spent. Tasks aimed at a RESCHEDULING group stay queued. A node that
announced its preemption is draining: task, actor and bundle placement
skip it.

While a capacity autoscaler runs (`core/capacity.py` clears
`fail_fast_infeasible`), demand that no node can meet stays queued for it
instead of failing: tasks wait in the queue, an unplaceable group is
registered PENDING and its rescheduler waits for capacity without
spending its budget. The autoscaler reads `pending_demand` /
`pending_task_demand` / `pending_gang_demand` and fails what no node type
could ever hold (`fail_unprovisionable`). Without one, such demand fails
at once, as before.
"""

from __future__ import annotations

import enum
import itertools
import logging
import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .exceptions import (
    OutOfResourcesError,
    PlacementGroupUnschedulableError,
    TaskCancelledError,
    TaskError,
)
from .ids import NodeID, ObjectID, PlacementGroupID, TaskID
from .resources import ResourceDict, ResourceSet

logger = logging.getLogger("ray_tpu_torch")



# --------------------------------------------------------------------------- spec


class SchedulingStrategy:
    """Base marker. String forms: "DEFAULT" (hybrid pack/spread), "SPREAD"."""


@dataclass
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    """Pin to a node."""

    node_id: NodeID
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    """Schedule into a reserved bundle."""

    placement_group: "PlacementGroup"
    placement_group_bundle_index: int = -1


@dataclass
class NodeLabelSchedulingStrategy(SchedulingStrategy):
    """Constrain placement by node labels.

    hard: every {key: [allowed values]} must match for a node to be
    eligible (a missing key never matches). soft: among eligible nodes,
    prefer those matching these too; fall back to any eligible node."""

    hard: Optional[Dict[str, List[str]]] = None
    soft: Optional[Dict[str, List[str]]] = None

    @staticmethod
    def _matches(labels: Dict[str, str], wants: Optional[Dict[str, List[str]]]) -> bool:
        for key, allowed in (wants or {}).items():
            if labels.get(key) not in allowed:
                return False
        return True


@dataclass
class TaskSpec:
    task_id: TaskID
    name: str
    func: Callable[..., Any]
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    num_returns: int = 1
    resources: ResourceDict = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    scheduling_strategy: Any = "DEFAULT"
    return_ids: List[ObjectID] = field(default_factory=list)
    runtime_env: Optional[Dict[str, Any]] = None  # normalized (runtime_env.py)
    # "thread" (default: in-process, zero-copy object passing) or "process"
    # (pooled OS worker process: GIL-free; see worker_pool.py)
    executor: str = "thread"
    # streaming generator task (num_returns="streaming"): yielded values
    # seal into dynamic return ids and flow through `stream`
    streaming: bool = False
    # weakref.ref to the consumer's ObjectRefGenerator: the spec must NOT
    # keep it alive, or consumer abandonment could never be detected
    # (the backpressured producer would block forever)
    stream: Any = None
    # producer flow control: block when the consumer lags this many items
    # behind (None = unbounded, the reference's default)
    stream_max_backlog: Optional[int] = None
    # soft locality preference: prefer this node when it is feasible
    # (data plane schedules map tasks next to their input block); never a
    # hard filter — a dead or saturated hinted node must not strand work
    locality_hint: Optional[NodeID] = None
    # a function a peer cannot import (check_importable): this process's
    # nodes only
    local_only: bool = False
    # internal
    attempt: int = 0
    # resubmits caused by node death (budgeted separately from user
    # max_retries: cfg.system_failure_retries)
    system_attempts: int = 0
    # times an agent bounced this dispatch ("busy"): drives requeue backoff
    bounces: int = 0
    cancelled: bool = False
    submitted_at: float = field(default_factory=time.monotonic)
    # observability (filled by the task runner)
    start_ts: float = 0.0
    end_ts: float = 0.0
    node_hex: str = ""
    # tracing (util/tracing): the submit span's context; the queue and
    # execute spans parent into it, and (re)submission stamps
    # submit_wall_ts so queue time is measurable per attempt
    trace_ctx: Any = None
    submit_wall_ts: float = field(default_factory=time.time)

    def live_stream(self):
        """The consumer's ObjectRefGenerator, or None once the consumer
        dropped it (stream is a weakref — abandonment detection)."""
        return self.stream() if self.stream is not None else None


# --------------------------------------------------------------------------- node


class Node:
    """A logical host with its own resource pool."""

    is_remote = False

    def __init__(self, node_id: NodeID, resources: ResourceDict, is_head: bool = False,
                 labels: Optional[Dict[str, str]] = None):
        self.node_id = node_id
        self.resources = ResourceSet(resources)
        self.is_head = is_head
        self.alive = True
        self.labels = labels or {}
        self.running_tasks: Dict[TaskID, TaskSpec] = {}
        self._lock = threading.Lock()
        # PREEMPTING (draining): the node announced its death (SIGTERM,
        # chaos preempt_node). It stays alive through the warning window,
        # so running work may finish or checkpoint, but placement skips it.
        self.draining = False
        self.drain_reason = ""
        self.drain_deadline = 0.0  # wall-clock time the node expects to die

    def placeable(self) -> bool:
        """Eligible to receive NEW tasks/actors/bundles."""
        return self.alive and not self.draining

    def utilization(self) -> float:
        total = self.resources.total
        avail = self.resources.available()
        fracs = [
            1.0 - avail.get(k, 0.0) / v for k, v in total.items() if v > 0
        ]
        return max(fracs) if fracs else 0.0

    def __repr__(self):
        return f"Node({self.node_id.hex()[:8]}, head={self.is_head})"


class RemoteNode(Node):
    """A node whose executor lives in another OS process (a joined node
    agent, core/cluster.py). Tasks dispatched here go over RPC to the
    agent at `agent_addr`; results arrive by push or stay remote and are
    pulled on get().

    The resource view is optimistic: this process accounts its own
    dispatches against the node's registered totals; the agent admits
    against its own ledger and bounces what it cannot queue."""

    is_remote = True

    def __init__(self, node_id: NodeID, resources: ResourceDict, agent_addr: str,
                 token: Optional[str] = None, labels: Optional[Dict[str, str]] = None):
        super().__init__(node_id, resources, is_head=False, labels=labels)
        self.agent_addr = agent_addr
        self.pid: Optional[int] = None  # the agent's process id, from its node entry
        from .rpc import RpcClient

        # execute_task returns "accepted" immediately; the timeout bounds
        # the dispatch round-trip, not the task's duration
        self.client = RpcClient(agent_addr, timeout=30.0, retries=0, token=token)

    def __repr__(self):
        return f"RemoteNode({self.node_id.hex()[:8]}, {self.agent_addr})"


# ------------------------------------------------------------------ placement grp


class PlacementStrategy(enum.Enum):
    PACK = "PACK"
    SPREAD = "SPREAD"
    STRICT_PACK = "STRICT_PACK"
    STRICT_SPREAD = "STRICT_SPREAD"


@dataclass
class Bundle:
    index: int
    resources: ResourceDict
    node: Optional[Node] = None
    reserved: ResourceSet = None  # type: ignore[assignment]


class PlacementGroup:
    """A gang reservation of resource bundles across nodes, all or
    nothing, strategy-constrained.

    States: PENDING -> RESERVED. A bundle host's death moves the group to
    RESCHEDULING: the owner re-reserves the dead bundles on surviving (or
    newly joined) nodes, under a budget of attempts over the group's
    lifetime with backoff. Success returns to RESERVED (queued tasks
    resume; budgeted bundle actors restart into the re-reserved bundles);
    a spent budget lands in FAILED, and every task aimed at the group
    fails with the death history. `remove` ends in REMOVED."""

    def __init__(self, pg_id: PlacementGroupID, bundles: List[Bundle],
                 strategy: PlacementStrategy, name: str = "",
                 max_reschedules: Optional[int] = None):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.created = threading.Event()
        self.removed = False
        self.state = "PENDING"  # RESERVED | RESCHEDULING | FAILED | REMOVED
        # None: cfg.pg_reschedule_budget when a reschedule starts
        self.max_reschedules = max_reschedules
        self.reschedules_used = 0
        self.death_history: List[Dict[str, Any]] = []
        self.failure_reason = ""
        self._reserved_event = threading.Event()
        self._rescheduler_running = False  # guarded-by: the scheduler's _lock

    def wait_reserved(self, timeout: Optional[float] = None) -> bool:
        """Block until the group holds a live reservation (True) or is
        FAILED or REMOVED (False). Bundle-actor restarts and a gang's
        re-mesh park here while a reschedule runs."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.state == "RESERVED":
                return True
            if self.state in ("FAILED", "REMOVED") or self.removed:
                return False
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return self.state == "RESERVED"
            self._reserved_event.wait(timeout=0.5 if remaining is None else min(remaining, 0.5))

    def ready(self, timeout: Optional[float] = None) -> bool:
        return self.created.wait(timeout)


# ---------------------------------------------------------------------- scheduler


class _ReusableThreadPool:
    """Grow-on-demand worker threads with an idle free-list.

    A task always gets a dedicated thread (so a blocking get() inside a
    task can never deadlock a fixed-size pool — concurrency is still gated
    by RESOURCES, not thread count), but finished threads park on a
    free-list and are reused instead of paying thread churn per task, and
    idle threads exit after `idle_timeout_s` or at `shutdown`."""

    def __init__(self, idle_timeout_s: float = 30.0, max_idle: int = 32,
                 name: str = "ray_tpu_torch-worker"):
        self._idle: List["queue.Queue"] = []  # guarded-by: _lock
        self._threads: List[threading.Thread] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._idle_timeout = idle_timeout_s
        self._max_idle = max_idle
        self._name = name
        self._spawned = 0  # observability: how many threads ever created

    def submit(self, fn: Callable[[], None]) -> None:
        with self._lock:
            q = self._idle.pop() if self._idle else None
            if q is None:
                q = queue.Queue()
                self._spawned += 1
                th = threading.Thread(
                    target=self._worker, args=(q,), daemon=True,
                    name=f"{self._name}-{self._spawned}",
                )
                self._threads = [t for t in self._threads if t.is_alive()] + [th]
                th.start()
        q.put(fn)

    def _worker(self, q: "queue.Queue") -> None:
        while True:
            try:
                fn = q.get(timeout=self._idle_timeout)
            except queue.Empty:
                # Idle reap — but a submitter may have popped our queue
                # between the timeout and this check. If our queue is no
                # longer on the free-list, a task is (about to be) in it:
                # keep serving. Otherwise deregister and exit.
                with self._lock:
                    if q in self._idle:
                        self._idle.remove(q)
                        return
                continue
            if fn is None:
                return  # shutdown
            try:
                fn()
            except BaseException:  # noqa: BLE001 - worker must survive
                logger.exception("task thread crashed outside the task boundary")
            fn = None  # a parked thread must not pin the task's closure
            with self._lock:
                if len(self._idle) >= self._max_idle:
                    return  # enough warm threads parked already
                self._idle.append(q)

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the parked threads and join every thread, waiting up to
        `timeout` seconds for tasks still running."""
        with self._lock:
            idle, self._idle = self._idle, []
            threads = list(self._threads)
        for q in idle:
            q.put(None)
        deadline = time.monotonic() + timeout
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))


class ClusterScheduler:
    """Resource-aware dispatcher over logical nodes.

    Policy: prefer packing onto already-utilized feasible nodes until a
    utilization threshold, then spread to the least-utilized feasible
    node. "SPREAD" always picks the least-utilized feasible node.
    """

    HYBRID_THRESHOLD = 0.5

    def __init__(self, object_store, on_task_done: Callable[[TaskSpec, Optional[BaseException]], None]):
        self._store = object_store
        self._nodes: Dict[NodeID, Node] = {}  # guarded-by: _lock
        self._pending: deque[TaskSpec] = deque()  # guarded-by: _lock
        self._blocked: Dict[TaskID, Tuple[TaskSpec, set]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._shutdown = False
        self._on_task_done = on_task_done
        self._placement_groups: Dict[PlacementGroupID, PlacementGroup] = {}  # guarded-by: _lock
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="ray_tpu_torch-scheduler", daemon=True
        )
        self._dispatch_thread.start()
        self.stats = {"dispatched": 0, "retries": 0, "spillbacks": 0}
        # Cluster hook (core/cluster.py): callable(spec, node, pool) that
        # ships a task to a RemoteNode's agent. Never raises — completion
        # (dispatch failure included) flows back through finish_remote.
        self.remote_dispatcher: Optional[Callable] = None
        # Cluster hooks for the two-phase reservation at agents:
        # reserver(pg_hex, bundles) -> None or an error string (it rolls
        # back its own partial progress); releaser(pg_hex, bundles),
        # best-effort; pg_state_sink(pg) records the group's state in the
        # GCS placement-group table
        self.remote_bundle_reserver: Optional[Callable] = None
        self.remote_bundle_releaser: Optional[Callable] = None
        self.pg_state_sink: Optional[Callable] = None
        # task execution threads: dedicated per running task (blocking
        # get() can never deadlock) but REUSED across tasks
        self._task_threads = _ReusableThreadPool()
        # With an autoscaler attached, "no node can ever satisfy" is a
        # provisioning signal, not an error: the demand stays queued for
        # the autoscaler to read. CapacityAutoscaler.start() clears this.
        self.fail_fast_infeasible = True

    # -------------------------------------------------------------- membership

    def add_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.node_id] = node
        self._wake.set()

    def remove_node(self, node_id: NodeID) -> Optional[Node]:
        with self._lock:
            node = self._nodes.pop(node_id, None)
            if node is not None:
                node.alive = False
        self._wake.set()
        return node

    def nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def mark_node_draining(self, node_hex: str, reason: str,
                           deadline: float = 0.0) -> Optional[Node]:
        """Flip a node to PREEMPTING (draining): placement skips it from
        now on and queued work re-plans onto the other nodes. Returns the
        node, or None when it is unknown (dead or departed)."""
        with self._lock:
            node = next((n for n in self._nodes.values() if n.node_id.hex() == node_hex), None)
            if node is None or node.draining:
                return node
            node.draining = True
            node.drain_reason = reason
            node.drain_deadline = deadline
        from ..util.events import emit
        from ..util.metrics import get_or_create_counter

        emit("WARNING", "cluster",
             f"node {node_hex[:12]} PREEMPTING: new placements stop ({reason})",
             kind="preempt.drain", node=node_hex, deadline=deadline)
        get_or_create_counter(
            "raytpu_node_preemptions_total",
            "Nodes that entered the PREEMPTING/draining state.",
        ).inc()
        self._wake.set()  # queued tasks re-plan around it
        return node

    def resident_bundles(self, node_hex: str) -> List[List[ResourceDict]]:
        """The bundles of live placement groups reserved on `node_hex`,
        one list per group."""
        with self._lock:
            pgs = list(self._placement_groups.values())
        out: List[List[ResourceDict]] = []
        for pg in pgs:
            if pg.removed or pg.state in ("FAILED", "REMOVED"):
                continue
            on_node = [dict(b.resources) for b in pg.bundles
                       if b.node is not None and b.node.node_id.hex() == node_hex]
            if on_node:
                out.append(on_node)
        return out

    def pending_demand(self) -> List[ResourceDict]:
        """Every pending resource demand: queued tasks that no node can
        take now, plus the unplaced bundles of groups waiting for capacity
        or rescheduling. The status summary and the capacity plane read
        the same list."""
        out = self.pending_task_demand()
        for gang in self.pending_gang_demand():
            out.extend(dict(r) for r in gang["bundles"])
        return out

    def pending_task_demand(self) -> List[ResourceDict]:
        """The resource requests of queued tasks only."""
        with self._lock:
            return [dict(spec.resources) for spec in self._pending]

    def pending_gang_demand(self) -> List[Dict[str, Any]]:
        """Unplaced placement-group bundles, one entry per group that
        waits for capacity (PENDING) or reschedules after a host's death,
        with the bundles that still need a node. The capacity plane plans
        each entry onto capacity launched together, never piecemeal."""
        with self._lock:
            pgs = list(self._placement_groups.values())
        out: List[Dict[str, Any]] = []
        for pg in pgs:
            if pg.removed or pg.state in ("RESERVED", "FAILED", "REMOVED"):
                continue
            unplaced = [dict(b.resources) for b in pg.bundles
                        if b.node is None or not b.node.alive]
            if unplaced:
                out.append({"pg": pg.id.hex(), "name": pg.name, "state": pg.state,
                            "bundles": unplaced})
        return out

    def fail_unprovisionable(self, can_provision: Callable[[ResourceDict], bool]) -> int:
        """Fail the queued tasks and waiting groups whose demand
        `can_provision(resources)` rejects; returns how many. The
        autoscaler calls it with its node types' coverage: with
        `fail_fast_infeasible` off, demand that no node type could ever
        hold would otherwise wait forever."""
        # the predicate runs outside the lock: it reads the cluster through
        # methods that take this same (non-reentrant) lock
        with self._lock:
            snapshot = list(self._pending)
        doomed = [spec for spec in snapshot if not can_provision(dict(spec.resources))]
        removed: List[TaskSpec] = []
        with self._lock:
            for spec in doomed:
                try:
                    self._pending.remove(spec)
                    removed.append(spec)
                except ValueError:
                    pass  # dispatched while it was judged: not doomed
        for spec in removed:
            self._fail_returns(
                spec,
                OutOfResourcesError(
                    f"Task {spec.name} requires {spec.resources}, which no current node "
                    f"or provisionable node type can satisfy"),
            )
        # groups waiting for capacity are judged the same way: a bundle no
        # node type could ever hold fails the group instead of parking it
        with self._lock:
            waiting = [pg for pg in self._placement_groups.values()
                       if not pg.removed and pg.state in ("PENDING", "RESCHEDULING")]
        failed_pgs = 0
        for pg in waiting:
            impossible = [dict(b.resources) for b in pg.bundles
                          if (b.node is None or not b.node.alive)
                          and not can_provision(dict(b.resources))]
            if impossible:
                pg.failure_reason = (f"bundle(s) {impossible} exceed every current node "
                                     f"and provisionable node type")
                self._pg_transition(pg, "FAILED", pg.failure_reason)
                failed_pgs += 1
        return len(removed) + failed_pgs

    def head_node(self) -> Node:
        with self._lock:
            for n in self._nodes.values():
                if n.is_head:
                    return n
            return next(iter(self._nodes.values()))

    def cluster_resources(self) -> ResourceDict:
        out: ResourceDict = {}
        for n in self.nodes():
            for k, v in n.resources.total.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def available_resources(self) -> ResourceDict:
        out: ResourceDict = {}
        for n in self.nodes():
            for k, v in n.resources.available().items():
                out[k] = out.get(k, 0.0) + v
        return out

    # -------------------------------------------------------------- submission

    def submit(self, spec: TaskSpec) -> None:
        """Queue a task; it dispatches once its ObjectID args are ready."""
        spec.submit_wall_ts = time.time()  # queue span measures THIS attempt
        deps = _collect_dependencies(spec.args, spec.kwargs)
        unresolved = {d for d in deps if not self._store.is_ready(d)}
        if unresolved:
            with self._lock:
                self._blocked[spec.task_id] = (spec, unresolved)
            for dep in list(unresolved):
                self._store.add_ready_callback(dep, self._make_dep_callback(spec.task_id, dep))
        else:
            with self._lock:
                self._pending.append(spec)
            self._wake.set()

    def _make_dep_callback(self, task_id: TaskID, dep: ObjectID):
        def _cb(_entry):
            with self._lock:
                item = self._blocked.get(task_id)
                if item is None:
                    return
                spec, unresolved = item
                unresolved.discard(dep)
                if not unresolved:
                    del self._blocked[task_id]
                    self._pending.append(spec)
                    self._wake.set()
        return _cb

    def cancel(self, task_id: TaskID) -> bool:
        """Cancel a queued task. Running tasks cannot be preempted
        (threads): mark-and-check instead."""
        to_fail = None
        with self._lock:
            item = self._blocked.pop(task_id, None)
            if item is not None:
                item[0].cancelled = True
                to_fail = item[0]
            else:
                for spec in self._pending:
                    if spec.task_id == task_id:
                        spec.cancelled = True
                        return True
        if to_fail is not None:
            # Outside the lock: seal_error runs dependency callbacks inline,
            # which re-enter the scheduler.
            self._fail_returns(to_fail, TaskCancelledError(f"task {task_id} cancelled"))
            return True
        return False

    # ---------------------------------------------------------- placement grps

    def create_placement_group(
        self, bundles: Sequence[ResourceDict], strategy: str = "PACK", name: str = "",
        max_reschedules: Optional[int] = None,
    ) -> PlacementGroup:
        """Reserve a gang of bundles, cluster-wide, all or nothing.

        A two-phase commit across node agents: phase 1 acquires each
        bundle on this process's view of its node under the scheduler
        lock; phase 2 asks every REMOTE bundle's agent to reserve against
        its own ledger (`remote_bundle_reserver`). An agent's refusal
        (another owner got there first) rolls the whole group back and
        replans, so the reservation stays all-or-nothing between owners
        that cannot see each other's dispatches."""
        strat = PlacementStrategy(strategy)
        last_err = f"Cannot fit bundles {list(bundles)} with strategy {strategy}"
        for _attempt in range(3):
            pg = PlacementGroup(
                PlacementGroupID.from_random(),
                [Bundle(i, dict(r)) for i, r in enumerate(bundles)],
                strat,
                name,
                max_reschedules=max_reschedules,
            )
            acquired: List[Tuple[Node, ResourceDict]] = []
            with self._lock:
                placement = self._plan_placement_locked(pg)
                if placement is None and self.fail_fast_infeasible:
                    raise PlacementGroupUnschedulableError(
                        f"Cannot fit bundles {list(bundles)} with strategy "
                        f"{strategy} on nodes "
                        f"{[n.resources.total for n in self._nodes.values() if n.placeable()]}"
                    )
                if placement is None:
                    # an autoscaler runs: the group is provisioning demand,
                    # not an error. It is registered and surfaces whole in
                    # pending_gang_demand; its rescheduler reserves it once
                    # capacity lands, without spending the budget
                    self._placement_groups[pg.id] = pg
                lost = False
                for bundle, node in zip(pg.bundles, placement or ()):
                    if not node.resources.try_acquire(bundle.resources):
                        # the plan counted every bundle under this lock, so
                        # only a concurrent task acquisition gets here
                        for prev_node, prev_res in acquired:
                            prev_node.resources.release(prev_res)
                        acquired.clear()
                        lost = True
                        break
                    acquired.append((node, bundle.resources))
                    bundle.node = node
                    bundle.reserved = ResourceSet(bundle.resources)
            if lost:
                last_err = "concurrent reservation lost"
                continue
            if placement is None:
                self._kick_reschedule(pg, "awaiting capacity (autoscaler attached)",
                                      [b.index for b in pg.bundles])
                return pg
            # phase 2, outside the lock (RPCs): prepare the remote bundles
            # at their agents; the hook reserves in order and rolls back
            # its own partial progress on a refusal
            remote = [b for b in pg.bundles if b.node is not None and b.node.is_remote]
            if remote and self.remote_bundle_reserver is not None:
                err = self.remote_bundle_reserver(pg.id.hex(), remote)
                if err is not None:
                    with self._lock:
                        for node, res in acquired:
                            node.resources.release(res)
                    last_err = err
                    continue
            with self._lock:
                self._placement_groups[pg.id] = pg
            self._pg_transition(pg, "RESERVED", "initial reservation")
            return pg
        raise PlacementGroupUnschedulableError(last_err)

    def _plan_placement_locked(self, pg: PlacementGroup) -> Optional[List[Node]]:  # holds-lock: _lock
        nodes = [n for n in self._nodes.values() if n.placeable()]
        if not nodes:
            return None
        strat = pg.strategy

        def fits(node: Node, req: ResourceDict, committed: Dict[NodeID, ResourceDict]) -> bool:
            avail = node.resources.available()
            extra = committed.get(node.node_id, {})
            return all(avail.get(k, 0.0) - extra.get(k, 0.0) >= v - 1e-9 for k, v in req.items())

        def commit(committed, node, req):
            slot = committed.setdefault(node.node_id, {})
            for k, v in req.items():
                slot[k] = slot.get(k, 0.0) + v

        committed: Dict[NodeID, ResourceDict] = {}
        placement: List[Node] = []
        if strat in (PlacementStrategy.PACK, PlacementStrategy.STRICT_PACK):
            order = sorted(nodes, key=lambda n: -n.utilization())
            for bundle in pg.bundles:
                chosen = None
                candidates = placement[:1] if (strat == PlacementStrategy.STRICT_PACK and placement) else order
                for node in candidates:
                    if fits(node, bundle.resources, committed):
                        chosen = node
                        break
                if chosen is None and strat == PlacementStrategy.PACK:
                    for node in order:
                        if fits(node, bundle.resources, committed):
                            chosen = node
                            break
                if chosen is None:
                    return None
                commit(committed, chosen, bundle.resources)
                placement.append(chosen)
        else:  # SPREAD / STRICT_SPREAD
            used: set = set()
            for bundle in pg.bundles:
                candidates = sorted(nodes, key=lambda n: (n.node_id in used, n.utilization()))
                chosen = None
                for node in candidates:
                    if strat == PlacementStrategy.STRICT_SPREAD and node.node_id in used:
                        continue
                    if fits(node, bundle.resources, committed):
                        chosen = node
                        break
                if chosen is None:
                    return None
                used.add(chosen.node_id)
                commit(committed, chosen, bundle.resources)
                placement.append(chosen)
        return placement

    def remove_placement_group(self, pg: PlacementGroup) -> None:
        with self._lock:
            self._placement_groups.pop(pg.id, None)
            pg.removed = True
            for bundle in pg.bundles:
                if bundle.node is not None and bundle.node.alive:
                    bundle.node.resources.release(bundle.resources)
        remote = [b for b in pg.bundles
                  if b.node is not None and b.node.is_remote and b.node.alive]
        if remote and self.remote_bundle_releaser is not None:
            self.remote_bundle_releaser(pg.id.hex(), remote)
        self._pg_transition(pg, "REMOVED")

    # ------------------------------------------------ placement-group states

    def get_placement_group(self, pg_hex: str) -> Optional[PlacementGroup]:
        with self._lock:
            return self._placement_groups.get(PlacementGroupID(pg_hex))

    def placement_groups(self) -> List[PlacementGroup]:
        with self._lock:
            return list(self._placement_groups.values())

    def _pg_transition(self, pg: PlacementGroup, state: str,
                       reason: str = "", **extra: Any) -> None:
        """Every state change of a group goes through here: the state, the
        event, the counter, the GCS table's record and a dispatch wake
        (queued tasks aimed at the group look at it again)."""
        pg.state = state
        if state == "RESCHEDULING":
            pg._reserved_event.clear()
        else:
            pg._reserved_event.set()
        if state == "RESERVED":
            pg.created.set()
        from ..util.events import emit
        from ..util.metrics import get_or_create_counter

        severity = "WARNING" if state in ("RESCHEDULING", "FAILED") else "INFO"
        emit(severity, "placement_groups",
             f"placement group {pg.id.hex()[:12]} -> {state}"
             + (f" ({reason})" if reason else ""),
             kind="pg.transition", pg=pg.id.hex(), state=state, **extra)
        get_or_create_counter(
            "raytpu_pg_state_transitions_total",
            "Placement-group FSM transitions by target state.",
            ("state",),
        ).inc(tags={"state": state})
        if self.pg_state_sink is not None:
            try:
                self.pg_state_sink(pg)
            except Exception:  # noqa: BLE001 - observability must not wedge the FSM
                logger.exception("placement-group state sink failed")
        self._wake.set()

    def _kick_reschedule(self, pg: PlacementGroup, reason: str,
                         bundle_indexes: List[int]) -> None:
        """Record the death and make sure exactly one rescheduler thread
        drives the group's recovery."""
        pg.death_history.append({
            "ts": time.time(),
            "bundles": list(bundle_indexes),
            "reason": reason,
        })
        with self._lock:
            if pg.removed or pg.state in ("FAILED", "REMOVED"):
                return
            if pg._rescheduler_running:
                return  # the running thread finds the dead bundles each attempt
            pg._rescheduler_running = True
        self._pg_transition(pg, "RESCHEDULING", reason, bundles=list(bundle_indexes))
        threading.Thread(
            target=self._reschedule_pg, args=(pg,), daemon=True,
            name=f"ray_tpu_torch-pg-reschedule-{pg.id.hex()[:8]}",
        ).start()

    def _reschedule_pg(self, pg: PlacementGroup) -> None:
        """The rescheduler thread: budgeted re-reservation with backoff.
        Attempts count over the group's lifetime, so a flapping group
        cannot thrash forever."""
        from .config import cfg

        budget = pg.max_reschedules if pg.max_reschedules is not None else cfg.pg_reschedule_budget
        backoff = max(cfg.pg_reschedule_backoff_s, 0.05)
        attempt = 0
        try:
            while True:
                if pg.removed or pg.state in ("FAILED", "REMOVED") or self._shutdown:
                    return
                if pg.reschedules_used >= budget:
                    self._fail_pg(pg, budget)
                    return
                pg.reschedules_used += 1
                attempt += 1
                err = self._try_reschedule_once(pg)
                if err is None:
                    self._pg_transition(pg, "RESERVED",
                                        f"re-reserved after {attempt} attempt(s)",
                                        reschedules_used=pg.reschedules_used)
                    return
                # with an autoscaler attached, a shortfall of capacity is a
                # wait for provisioning, not a failed attempt: the budget
                # unit is refunded and the retry runs at the base backoff
                # (fail_unprovisionable fails the impossible groups)
                waiting_capacity = (not self.fail_fast_infeasible
                                    and err.startswith("no surviving node"))
                if waiting_capacity:
                    pg.reschedules_used -= 1
                if not waiting_capacity or attempt == 1:
                    from ..util.events import emit

                    emit("WARNING", "placement_groups",
                         f"placement group {pg.id.hex()[:12]} reschedule attempt {attempt} "
                         f"failed: {err}", kind="pg.reschedule_failed", pg=pg.id.hex())
                    logger.warning("PG %s reschedule attempt %d failed: %s",
                                   pg.id.hex()[:12], attempt, err)
                if pg.reschedules_used >= budget:
                    self._fail_pg(pg, budget)
                    return
                if waiting_capacity:
                    time.sleep(backoff)
                else:
                    time.sleep(min(backoff * (2 ** (attempt - 1)), 8.0))
        finally:
            with self._lock:
                pg._rescheduler_running = False
            # a death that landed between the final transition and the
            # flag's clearing found the thread "running" and was skipped:
            # kick again so it is never lost
            if not pg.removed and pg.state == "RESERVED":
                late = [b.index for b in pg.bundles if b.node is not None and not b.node.alive]
                if late:
                    self._kick_reschedule(pg, "bundle host died during rescheduling", late)

    def _try_reschedule_once(self, pg: PlacementGroup) -> Optional[str]:
        """One re-reservation round for every dead bundle: plan and
        acquire under the lock, probe and commit at the agents outside
        it, repoint the bundles only when every grant landed. None on
        success, else the reason to retry."""
        from .health import probe_agent

        acquired: List[Tuple[Node, ResourceDict]] = []
        replacements: List[Tuple[Bundle, Node]] = []

        def rollback() -> None:  # holds-lock: _lock
            for node, res in acquired:
                node.resources.release(res)

        with self._lock:
            dead = [b for b in pg.bundles if b.node is None or not b.node.alive]
            if not dead:
                return None  # healed concurrently
            alive = [n for n in self._nodes.values() if n.placeable()]
            held = {b.node.node_id for b in pg.bundles if b.node is not None and b.node.alive}
            pack_node: Optional[Node] = (
                next((b.node for b in pg.bundles if b.node is not None and b.node.alive), None)
                if pg.strategy == PlacementStrategy.STRICT_PACK else None
            )
            for bundle in dead:
                if pg.strategy == PlacementStrategy.STRICT_SPREAD:
                    candidates = [n for n in alive if n.node_id not in held]
                elif pg.strategy == PlacementStrategy.STRICT_PACK:
                    candidates = [pack_node] if pack_node is not None else alive
                else:
                    candidates = list(alive)
                chosen = None
                for node in sorted(candidates, key=lambda n: n.utilization()):
                    if node.resources.try_acquire(bundle.resources):
                        chosen = node
                        break
                if chosen is None:
                    rollback()
                    return (f"no surviving node can host bundle {bundle.index} "
                            f"({bundle.resources}) under {pg.strategy.value}")
                acquired.append((chosen, dict(bundle.resources)))
                replacements.append((bundle, chosen))
                held.add(chosen.node_id)
                if pack_node is None:
                    pack_node = chosen
        # outside the lock: probe the remote candidates (a death may not
        # have aged out of the heartbeats yet), then phase 2 at the agents
        remote = [(b, n) for b, n in replacements if n.is_remote]
        for _, node in remote:
            if not probe_agent(node):
                with self._lock:
                    rollback()
                return f"candidate node {node.node_id.hex()[:12]} is unresponsive"
        if remote and self.remote_bundle_reserver is not None:
            shims = [Bundle(b.index, dict(b.resources), node=node) for b, node in remote]
            err = self.remote_bundle_reserver(pg.id.hex(), shims)
            if err is not None:
                with self._lock:
                    rollback()
                return err
        with self._lock:
            for bundle, node in replacements:
                bundle.node = node
                bundle.reserved = ResourceSet(bundle.resources)
        return None

    def _fail_pg(self, pg: PlacementGroup, budget: int) -> None:
        history = "; ".join(f"bundles {h['bundles']} lost ({h['reason']})"
                            for h in pg.death_history)
        pg.failure_reason = (f"rescheduling budget exhausted ({budget} attempt(s)); "
                             f"death history: {history or 'none'}")
        self._pg_transition(pg, "FAILED", pg.failure_reason)

    # ----------------------------------------------------------- dispatch loop

    def _dispatch_loop(self) -> None:
        while not self._shutdown:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            self._drain_pending()

    def _drain_pending(self) -> None:
        deferred: List[TaskSpec] = []
        while True:
            with self._lock:
                if not self._pending:
                    break
                spec = self._pending.popleft()
            if spec.cancelled:
                self._fail_returns(spec, TaskCancelledError(f"task {spec.task_id} cancelled"))
                continue
            try:
                placed = self._try_dispatch(spec)
            except BaseException as exc:  # noqa: BLE001 - the dispatch loop must survive
                logger.exception("dispatch of %s failed", spec.name)
                self._fail_returns(spec, TaskError(spec.name, exc))
                continue
            if not placed:
                deferred.append(spec)
        if deferred:
            with self._lock:
                self._pending.extendleft(reversed(deferred))

    def _remotable(self, spec: TaskSpec) -> bool:
        """Whether a node agent may run this task: not a function a peer
        cannot import, not a streaming task on the process executor (a
        generator cannot cross the worker pipe either), and only with a
        cluster attached."""
        return (
            not spec.local_only
            and not (spec.streaming and spec.executor == "process")
            and self.remote_dispatcher is not None
        )

    def _try_dispatch(self, spec: TaskSpec) -> bool:
        target: Optional[Node] = None
        pool: Optional[ResourceSet] = None
        remotable = self._remotable(spec)

        strategy = spec.scheduling_strategy
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            idx = strategy.placement_group_bundle_index
            bundles = pg.bundles if idx < 0 else [pg.bundles[idx]]
            live = []
            for bundle in bundles:
                if bundle.node is not None and not bundle.node.alive:
                    continue  # its host died: never dispatch into a void
                if bundle.node is not None and bundle.node.is_remote and not remotable:
                    continue
                live.append(bundle)
                if bundle.reserved is not None and bundle.reserved.try_acquire(spec.resources):
                    target, pool = bundle.node, bundle.reserved
                    break
            if target is None:
                if pg.state == "FAILED":
                    # the rescheduling budget is spent: fail with the
                    # death history instead of queueing forever
                    self._fail_returns(
                        spec,
                        OutOfResourcesError(
                            f"Task {spec.name}: placement group {pg.id.hex()[:12]} "
                            f"failed: {pg.failure_reason}"),
                    )
                    return True
                dead = [b for b in bundles if b.node is not None and not b.node.alive]
                if not live and dead and pg.state == "RESERVED":
                    # a host death seen here before any death notice reached
                    # the group (a direct remove_node): start the reschedule
                    self._kick_reschedule(pg, "bundle host observed dead at dispatch",
                                          [b.index for b in dead])
                # RESCHEDULING, or a bundle is busy: stay queued
                return False
        elif isinstance(strategy, NodeAffinitySchedulingStrategy):
            with self._lock:
                node = self._nodes.get(strategy.node_id)
            if node is not None and node.is_remote and not remotable:
                if not strategy.soft:
                    self._fail_returns(
                        spec,
                        OutOfResourcesError(
                            f"Task {spec.name} (local-only or streaming on the process "
                            f"executor) cannot run on remote node {strategy.node_id}"
                        ),
                    )
                    return True
                node = None  # soft affinity: fall back to a local node
            if node is None or not node.alive:
                if not strategy.soft:
                    self._fail_returns(
                        spec, OutOfResourcesError(f"node {strategy.node_id} not available")
                    )
                    return True
            elif not strategy.soft and not node.resources.can_ever_fit(spec.resources):
                self._fail_returns(
                    spec,
                    OutOfResourcesError(
                        f"Task {spec.name} pinned to a node that can never satisfy "
                        f"{spec.resources} (node total: {node.resources.total})"
                    ),
                )
                return True
            elif node.resources.try_acquire(spec.resources):
                target, pool = node, node.resources
            if target is None and not strategy.soft:
                return False
            if target is None:
                target = self._pick_node(spec)
                if target is None:
                    return False
                if not target.resources.try_acquire(spec.resources):
                    return False
                pool = target.resources
        else:
            node = self._pick_node(spec)
            if node is None:
                if not self.fail_fast_infeasible:
                    return False  # the autoscaler provisions for this demand
                # fail fast iff the SAME eligibility _pick_node applies
                # (alive + hard labels) can never satisfy
                candidates = self._eligible_nodes(spec)
                if (
                    isinstance(strategy, NodeLabelSchedulingStrategy)
                    and not candidates
                    and self.nodes()
                ):
                    self._fail_returns(
                        spec,
                        OutOfResourcesError(
                            f"Task {spec.name}: no eligible node matches hard "
                            f"labels {strategy.hard}"
                        ),
                    )
                    return True
                feasible = any(
                    n.resources.can_ever_fit(spec.resources) for n in candidates
                )
                if not feasible and self.nodes():
                    self._fail_returns(
                        spec,
                        OutOfResourcesError(
                            f"Task {spec.name} requires {spec.resources} which no node "
                            f"can ever satisfy (cluster: {self.cluster_resources()})"
                        ),
                    )
                    return True
                return False
            if not node.resources.try_acquire(spec.resources):
                return False
            target, pool = node, node.resources

        self.stats["dispatched"] += 1
        with target._lock:
            target.running_tasks[spec.task_id] = spec
        if target.is_remote:
            # the dispatcher thread covers only the (bounded) dispatch RPC;
            # completion arrives through finish_remote when the agent
            # reports task_done
            self._task_threads.submit(
                lambda s=spec, t=target, p=pool: self.remote_dispatcher(s, t, p)
            )
        else:
            self._task_threads.submit(
                lambda s=spec, t=target, p=pool: self._run_task(s, t, p)
            )
        return True

    # Hybrid policy randomizes among this many top candidates so a burst
    # of submitters doesn't herd onto one node.
    HYBRID_TOP_K = 2

    def _eligible_nodes(self, spec: TaskSpec) -> List[Node]:
        """Every placement filter EXCEPT current availability: alive,
        remotable (local-only tasks stay on this process's nodes) and hard
        label match — the one definition both _pick_node and the fail-fast
        infeasibility check must agree on. Soft labels are a PREFERENCE
        applied over currently-feasible nodes in _pick_node, never a
        filter here."""
        remotable = self._remotable(spec)
        nodes = [n for n in self.nodes()
                 if n.placeable() and (remotable or not n.is_remote)]
        strategy = spec.scheduling_strategy
        if isinstance(strategy, NodeLabelSchedulingStrategy):
            nodes = [
                n for n in nodes
                if NodeLabelSchedulingStrategy._matches(n.labels, strategy.hard)
            ]
        return nodes

    def _arg_locality(self, spec: TaskSpec, nodes: List[Node]) -> Dict[NodeID, int]:
        """Bytes of the task's REMOTE-located args per candidate node: the
        policy pulls toward nodes already holding large dependencies."""
        from .object_store import Tier
        from .runtime import ObjectRef

        scores: Dict[NodeID, int] = {}
        for value in itertools.chain(spec.args, spec.kwargs.values()):
            if not isinstance(value, ObjectRef):
                continue
            entry = self._store.entry(value.object_id)
            if (entry is None or entry.tier != Tier.REMOTE
                    or not isinstance(entry.value, str)):
                continue
            for node in nodes:
                if getattr(node, "agent_addr", None) == entry.value:
                    scores[node.node_id] = scores.get(node.node_id, 0) + max(entry.nbytes, 1)
        return scores

    def _pick_node(self, spec: TaskSpec) -> Optional[Node]:
        import random

        nodes = self._eligible_nodes(spec)
        strategy = spec.scheduling_strategy
        feasible = [
            n for n in nodes
            if all(n.resources.available().get(k, 0.0) >= v - 1e-9 for k, v in spec.resources.items())
        ]
        if not feasible:
            return None
        if isinstance(strategy, NodeLabelSchedulingStrategy) and strategy.soft:
            preferred = [
                n for n in feasible
                if NodeLabelSchedulingStrategy._matches(n.labels, strategy.soft)
            ]
            feasible = preferred or feasible
        if strategy == "SPREAD":
            return min(feasible, key=lambda n: n.utilization())
        # Arg locality first: a feasible node already holding the task's
        # large remote args wins (the pull it saves usually dwarfs any
        # packing gain).
        locality = self._arg_locality(spec, feasible)
        if locality:
            return max(feasible, key=lambda n: locality.get(n.node_id, 0))
        # Explicit locality hint next (data-plane block affinity): honor
        # it whenever the hinted node is feasible right now.
        if spec.locality_hint is not None:
            for n in feasible:
                if n.node_id == spec.locality_hint:
                    return n
        # Hybrid: pack onto busy-but-below-threshold nodes first, else
        # spread to the emptiest — randomized among the top-k candidates.
        below = [n for n in feasible if n.utilization() < self.HYBRID_THRESHOLD]
        if below:
            ranked = sorted(below, key=lambda n: -n.utilization())
        else:
            ranked = sorted(feasible, key=lambda n: n.utilization())
        return random.choice(ranked[: self.HYBRID_TOP_K])

    # ------------------------------------------------------------- task runner

    def _run_task(self, spec: TaskSpec, node: Node, pool: ResourceSet) -> None:
        from ..util import logs as _logs
        from ..util import tracing

        error: Optional[BaseException] = None
        error_tb = ""
        spec.start_ts = time.time()
        spec.node_hex = node.node_id.hex()
        # debuggability: the (reused) thread carries the task it runs
        threading.current_thread().name = (
            f"ray_tpu_torch-worker-{spec.name}-{spec.task_id.hex()[:6]}"
        )
        lane = f"node:{spec.node_hex[:8]}"
        span_attrs = {"task": spec.name, "task_id": spec.task_id.hex(),
                      "attempt": spec.attempt}
        # the wait between (re)submission and this thread picking the
        # task up IS the scheduling/queue latency
        tracing.tracer().record_span(
            "task.queue", spec.submit_wall_ts, spec.start_ts,
            parent=spec.trace_ctx, lane=lane, attrs=span_attrs,
        )
        exec_span = tracing.tracer().start_span(
            "task.execute", parent=spec.trace_ctx, lane=lane, attrs=span_attrs,
        )
        try:
            # current-span context active for the task body: nested
            # submits/gets parent into this execution span; log records
            # emitted inside it carry the task attribution
            with tracing.use_context(exec_span.context), \
                    _logs.attribution(f"task:{spec.task_id.hex()[:8]}"):
                from . import chaos

                chaos.maybe_inject(spec.name, node=node)
                if spec.executor == "process":
                    # a pooled worker process; SHM-tier args ship as
                    # zero-copy arena descriptors
                    from .worker_pool import execute_process_task

                    result = execute_process_task(
                        self._store, spec.func, spec.args, spec.kwargs, spec.runtime_env,
                    )
                else:
                    from . import runtime_env as _renv

                    args = _resolve(spec.args, self._store)
                    kwargs = _resolve(spec.kwargs, self._store)
                    with _renv.applied(spec.runtime_env):
                        result = spec.func(*args, **kwargs)
                with tracing.span("task.result", **span_attrs):
                    self._seal_returns(spec, result)
            exec_span.end()
        except BaseException as exc:  # noqa: BLE001 - boundary: remote error capture
            error = exc
            # process-executor errors carry the worker's traceback
            error_tb = getattr(exc, "remote_traceback", None) or traceback.format_exc()
            exec_span.end(status="ERROR", error=repr(exc))
        finally:
            pool.release(spec.resources)
            with node._lock:
                node.running_tasks.pop(spec.task_id, None)

        self._complete(spec, error, error_tb)

    def _complete(self, spec: TaskSpec, error: Optional[BaseException],
                  error_tb: str = "", system_failure: bool = False) -> None:
        """Completion tail for local and remote execution: retry
        bookkeeping, return sealing on failure, task-done event."""
        if error is not None:
            if system_failure:
                # the executing node died — not the task's fault; budgeted
                # apart from user retries
                from .config import cfg

                if spec.system_attempts < cfg.system_failure_retries and not spec.cancelled:
                    spec.system_attempts += 1
                    self.stats["retries"] += 1
                    logger.warning("resubmitting task %s after node failure (%d): %s",
                                   spec.name, spec.system_attempts, error)
                    self.submit(spec)
                    return
                self._fail_returns(spec, error)
                spec.end_ts = time.time()
                self._on_task_done(spec, error)
                self._wake.set()
                return
            retriable = spec.attempt < spec.max_retries and (
                spec.retry_exceptions is True
                or (isinstance(spec.retry_exceptions, (list, tuple))
                    and isinstance(error, tuple(spec.retry_exceptions)))
            )
            if retriable and not spec.cancelled:
                spec.attempt += 1
                self.stats["retries"] += 1
                logger.warning("retrying task %s (attempt %d): %s", spec.name, spec.attempt, error)
                self.submit(spec)
                return
            self._fail_returns(spec, TaskError(spec.name, error, error_tb))
        spec.end_ts = time.time()
        self._on_task_done(spec, error)
        self._wake.set()

    def requeue_remote(self, spec: TaskSpec, node: Node, pool: ResourceSet) -> None:
        """An agent bounced a dispatched task ("busy": its own ledger is
        full and its admission queue overflowed — another driver is
        saturating it). Not a failure and not a retry: release the
        owner-side reservation and resubmit after a backoff that grows per
        bounce, so a stale view cannot turn into a hot dispatch/bounce
        loop."""
        pool.release(spec.resources)
        with node._lock:
            node.running_tasks.pop(spec.task_id, None)
        self.stats["spillbacks"] += 1
        delay = min(0.2 * (2 ** min(spec.bounces, 4)), 2.0)
        spec.bounces += 1
        timer = threading.Timer(delay, lambda: self.submit(spec))
        timer.daemon = True
        timer.start()

    def finish_remote(self, spec: TaskSpec, node: Node, pool: ResourceSet,
                      error: Optional[BaseException] = None, error_tb: str = "",
                      system_failure: bool = False,
                      before_complete: Optional[Callable[[], None]] = None) -> None:
        """Completion of a remotely dispatched task (the agent reported
        task_done, or its node died): release the reservation on the
        node's view, run `before_complete` (the cluster seals the returns
        there, after the release), complete. A success records its
        task-done event BEFORE the returns seal, so a caller woken by a
        value always finds the task in the event log (the data plane reads
        where a block's task ran from it)."""
        pool.release(spec.resources)
        with node._lock:
            node.running_tasks.pop(spec.task_id, None)
        if error is None:
            self._complete(spec, None)
            if before_complete is not None:
                before_complete()
            return
        if before_complete is not None:
            before_complete()
        self._complete(spec, error, error_tb, system_failure=system_failure)

    def handle_node_death(self, node_hex: str, reason: str,
                          tasks: Sequence[Tuple[TaskSpec, Node, ResourceSet]] = ()) -> None:
        """A node's death (heartbeat-confirmed, or a logical node's
        preemption window closing): drop the node from the view, resubmit
        every task that was in flight there (`tasks`, the cluster's
        dispatch records, already claimed so a late task_done reads stale)
        under the system-failure budget, and move every placement group
        with a bundle there to RESCHEDULING."""
        from .worker_pool import WorkerCrashedError

        with self._lock:
            node = next((n for n in self._nodes.values()
                         if n.node_id.hex() == node_hex), None)
        if node is not None:
            self.remove_node(node.node_id)
        for spec, on_node, pool in tasks:
            self.finish_remote(
                spec, on_node, pool,
                error=WorkerCrashedError(
                    f"node {node_hex[:12]} executing task {spec.name} died: {reason}"),
                system_failure=True,
            )
        with self._lock:
            pgs = list(self._placement_groups.values())
        for pg in pgs:
            dead = [b.index for b in pg.bundles
                    if b.node is not None and b.node.node_id.hex() == node_hex]
            if dead:
                self._kick_reschedule(pg, f"node {node_hex[:12]} died: {reason}", dead)

    def _seal_returns(self, spec: TaskSpec, result: Any) -> None:
        if spec.streaming:
            self._seal_streaming(spec, result)
            return
        if spec.num_returns == 1:
            self._store.seal(spec.return_ids[0], result)
        else:
            values = list(result) if result is not None else []
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"Task {spec.name} declared num_returns={spec.num_returns} "
                    f"but returned {len(values)} values"
                )
            for oid, value in zip(spec.return_ids, values):
                self._store.seal(oid, value)

    def _seal_streaming(self, spec: TaskSpec, result: Any) -> None:
        """Drain a generator task: each yield seals into its own dynamic
        return id (task_id ⊕ index) and is handed to the consumer stream
        immediately. Yield indices are deterministic, so a retry or a
        lineage reconstruction re-seals the same ids; indices the stream
        already delivered are not re-appended."""
        if not hasattr(result, "__iter__"):
            raise TypeError(
                f"streaming task {spec.name} must return an iterable/generator, "
                f"got {type(result).__name__}"
            )
        stream = spec.live_stream()
        already = stream._appended if stream is not None else 0
        for idx, item in enumerate(result):
            if stream is not None and spec.stream_max_backlog:
                stream._wait_backlog(spec.stream_max_backlog)
            oid = ObjectID.for_task_return(spec.task_id, idx)
            self._store.create(oid, owner_task=spec)
            self._store.seal(oid, item)
            if oid not in spec.return_ids:
                spec.return_ids.append(oid)  # lineage: reconstruct flips these
            if stream is not None and idx >= already:
                stream._append_oid(oid)
        if stream is not None:
            stream._finish()

    def _fail_returns(self, spec: TaskSpec, error: BaseException) -> None:
        if spec.streaming:
            # Never clobber successfully yielded values; only slots a
            # reconstruction flipped back to PENDING must error out (or a
            # getter would hang forever). The consumer sees the error from
            # the stream itself, after the last good item.
            for oid in spec.return_ids:
                entry = self._store.entry(oid)
                if entry is not None and not entry.event.is_set():
                    self._store.seal_error(oid, error)
            stream = spec.live_stream()
            if stream is not None:
                stream._finish(error)
            return
        for oid in spec.return_ids:
            self._store.seal_error(oid, error)

    def shutdown(self) -> None:
        self._shutdown = True
        self._wake.set()
        self._dispatch_thread.join(timeout=2.0)
        self._task_threads.shutdown()


# ----------------------------------------------------------------------- helpers


def _collect_dependencies(args, kwargs) -> List[ObjectID]:
    from .runtime import ObjectRef  # cycle-free at call time

    deps = []
    for value in itertools.chain(args, kwargs.values()):
        if isinstance(value, ObjectRef):
            deps.append(value.object_id)
    return deps


def _resolve(container, store):
    from .runtime import ObjectRef

    if isinstance(container, tuple):
        return tuple(store.get(v.object_id) if isinstance(v, ObjectRef) else v for v in container)
    return {
        k: (store.get(v.object_id) if isinstance(v, ObjectRef) else v)
        for k, v in container.items()
    }
