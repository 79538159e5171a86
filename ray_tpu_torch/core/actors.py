"""Actor runtime: lifecycle FSM, mailbox execution, restarts.

Port of `ray_tpu/core/actors.py` for thread actors. An actor is a
dedicated thread owning a Python instance; methods are messages on a
mailbox queue, executed in order (or on a pool of `max_concurrency`
threads). The actor's resources are held for its lifetime (leased from a
node or a placement-group bundle). FSM: PENDING → ALIVE → RESTARTING →
DEAD; a restartable death re-runs the constructor up to `max_restarts`
times. A bundle actor whose host died restarts into its bundle once the
group has re-reserved it (on a local node here; on an agent through
`core/cluster.py`). Method exceptions do NOT kill the actor; only kill()
and a constructor that raises do. When an incarnation stops (killed, restarted
or shut down), its instance's `__ray_shutdown__()` runs, if it has one.

Constructor arguments reach a thread actor's instance by reference: a
serve replica built with a tensor of weights holds the caller's tensor,
not a copy. A process actor (`executor="process"`) keeps its instance in
a worker process of its own (`worker_pool.WorkerProcess`, started with
the actor's runtime env), and its method calls go over the worker's pipe
by value, one at a time even with `max_concurrency > 1`; the worker's
death is a restartable actor death, found by the call in flight or by the
runtime's health manager between calls.
"""

from __future__ import annotations

import enum
import logging
import os
import queue
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .exceptions import ActorDiedError, TaskError
from .ids import ActorID, ObjectID, TaskID
from .resources import ResourceDict, ResourceSet
from .scheduler import (
    ClusterScheduler,
    Node,
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

logger = logging.getLogger("ray_tpu_torch")


class ActorState(enum.Enum):
    PENDING = "PENDING"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


@dataclass
class ActorMethodCall:
    task_id: TaskID
    method_name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    return_ids: List[ObjectID]
    num_returns: int = 1
    # streaming generator method (num_returns="streaming"): yields flow
    # through `stream`
    streaming: bool = False
    stream: Any = None
    # caller's actor.call span context: the mailbox hop crosses threads,
    # so the execution span re-parents from this, not a contextvar
    trace_ctx: Any = None

    def fail(self, store, error: BaseException) -> None:
        """Seal `error` into every unresolved return slot and close the
        stream. The one shared failure path for kill/restart/crash."""
        for oid in self.return_ids:
            entry = store.entry(oid)
            if entry is None or not entry.event.is_set():
                store.seal_error(oid, error)
        if self.stream is not None:
            self.stream._finish(error)


_POISON = object()


class ActorRuntime:
    """The server half of an actor: placement + mailbox + executor thread."""

    def __init__(
        self,
        actor_id: ActorID,
        cls: type,
        init_args: Tuple[Any, ...],
        init_kwargs: Dict[str, Any],
        resources: ResourceDict,
        scheduler: ClusterScheduler,
        object_store,
        scheduling_strategy: Any = "DEFAULT",
        max_restarts: int = 0,
        max_concurrency: int = 1,
        name: str = "",
        on_death=None,
        registered_name: Optional[str] = None,
        registered_namespace: str = "default",
        executor: str = "thread",
        runtime_env: Optional[Dict[str, Any]] = None,
        placement_pool: Optional[ResourceSet] = None,
    ):
        self.actor_id = actor_id
        self.cls = cls
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.resources = dict(resources)
        self.scheduling_strategy = scheduling_strategy
        self.max_restarts = max_restarts
        self.max_concurrency = max_concurrency
        self.name = name or cls.__name__
        self.state = ActorState.PENDING
        self.num_restarts = 0
        self.death_cause = ""
        self.registered_name = registered_name
        self.registered_namespace = registered_namespace
        self._on_death = on_death
        # "process": the instance lives in a worker process; method calls
        # are proxied over its pipe (state survives in the child; a crash
        # is a restartable actor death)
        self.executor = executor
        self.runtime_env = runtime_env  # normalized; process actors only
        # a node agent hosting a bundle actor for a remote owner: the
        # bundle's reserved pool on this node (core/cluster.py)
        self.placement_pool = placement_pool
        self._worker = None  # WorkerProcess when executor == "process"
        self._worker_lock = threading.Lock()  # serializes the worker's pipe
        self._incarnation = 0  # bumped on every (re)start; see _RestartSignal

        self._scheduler = scheduler
        self._store = object_store
        self._mailbox: "queue.Queue[Any]" = queue.Queue()
        self._node: Optional[Node] = None
        self._pool: Optional[ResourceSet] = None
        self._instance: Any = None
        self._lock = threading.Lock()
        # Calls currently executing; _die fails them immediately. The
        # zombie thread may still finish and re-seal a value over the
        # error — acceptable: kill-vs-result is racy anyway.
        self._inflight: List[ActorMethodCall] = []
        self._thread = threading.Thread(
            target=self._lifecycle, name=f"ray_tpu_torch-actor-{self.name}", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------------- placement

    def _acquire_placement(self) -> bool:
        """Block until resources are leased; returns False if impossible."""
        strategy = self.scheduling_strategy
        deadline_warned = False
        while True:
            with self._lock:
                if self.state == ActorState.DEAD:
                    return False
            if self.placement_pool is not None:
                # hosted for a remote owner in a bundle reserved here:
                # lease straight from its pool
                if not self.placement_pool.can_ever_fit(self.resources):
                    self.death_cause = f"reserved bundle cannot ever satisfy {self.resources}"
                    return False
                if self.placement_pool.try_acquire(self.resources):
                    self._node, self._pool = self._scheduler.head_node(), self.placement_pool
                    return True
                if self.placement_pool.closed:
                    self.death_cause = "its placement-group bundle was released"
                    return False
            elif isinstance(strategy, PlacementGroupSchedulingStrategy):
                pg = strategy.placement_group
                idx = strategy.placement_group_bundle_index
                try:
                    bundles = pg.bundles if idx < 0 else [pg.bundles[idx]]
                except IndexError:
                    self.death_cause = f"bundle index {idx} out of range"
                    return False
                if pg.state == "FAILED":
                    self.death_cause = f"placement group failed: {pg.failure_reason}"
                    return False
                # a remote bundle is the cluster's (can_place_actor_remotely,
                # before this runs); a dead host's bundle waits for the
                # group's reschedule, which repoints it (a restart lands
                # in the re-reserved bundle)
                had_remote = any(b.node is not None and b.node.is_remote for b in bundles)
                bundles = [b for b in bundles if b.node is None or not b.node.is_remote]
                if pg.state != "RESCHEDULING" and not any(
                    b.reserved is not None and b.reserved.can_ever_fit(self.resources)
                    for b in bundles
                ):
                    self.death_cause = (
                        f"no local bundle in placement group can ever satisfy "
                        f"{self.resources}"
                        + (" (its remote bundles were unusable too: dead host or "
                           "released lease)" if had_remote else "")
                    )
                    return False
                for bundle in bundles:
                    if bundle.node is not None and not bundle.node.alive:
                        continue
                    if bundle.reserved is not None and bundle.reserved.try_acquire(self.resources):
                        self._node, self._pool = bundle.node, bundle.reserved
                        return True
            elif isinstance(strategy, NodeAffinitySchedulingStrategy):
                node = next(
                    (n for n in self._scheduler.nodes() if n.node_id == strategy.node_id), None
                )
                if node is not None and node.is_remote:
                    # an actor on another node is a cluster proxy, placed
                    # before this runs (runtime.create_actor); here it would
                    # run in this process against that node's view
                    if not strategy.soft:
                        self.death_cause = (
                            f"actors cannot be placed on remote node {strategy.node_id}"
                        )
                        return False
                    strategy = "DEFAULT"  # soft affinity: default local placement
                    continue
                if node is not None and not node.resources.can_ever_fit(self.resources):
                    self.death_cause = (
                        f"affinity node cannot ever satisfy {self.resources}"
                    )
                    return False
                if node is not None and node.resources.try_acquire(self.resources):
                    self._node, self._pool = node, node.resources
                    return True
                if node is None and not strategy.soft:
                    self.death_cause = f"affinity node {strategy.node_id} not found"
                    return False
                if node is None:
                    strategy = "DEFAULT"  # soft affinity: default placement
                    continue
            else:
                nodes = sorted(
                    (n for n in self._scheduler.nodes() if not n.is_remote and n.placeable()),
                    key=lambda n: n.utilization(),
                )
                feasible = [n for n in nodes if n.resources.can_ever_fit(self.resources)]
                if not feasible and nodes:
                    self.death_cause = (
                        f"no node can ever satisfy actor resources {self.resources}"
                    )
                    return False
                for node in feasible:
                    if node.resources.try_acquire(self.resources):
                        self._node, self._pool = node, node.resources
                        return True
            if not deadline_warned:
                deadline_warned = True
                logger.debug("actor %s waiting for resources %s", self.name, self.resources)
            time.sleep(0.005)

    # ---------------------------------------------------------------- lifecycle

    def _lifecycle(self) -> None:
        while True:
            self._incarnation += 1
            if not self._acquire_placement():
                self._die(self.death_cause or "unschedulable")
                return
            try:
                if self.executor == "process":
                    from .runtime_env import worker_env_vars
                    from .worker_pool import WorkerProcess

                    self._worker = WorkerProcess(
                        worker_env_vars(self.runtime_env),
                        working_dir=(self.runtime_env or {}).get("working_dir"),
                    )
                    self._worker.request(
                        "actor_create", (self.cls, self.init_args, self.init_kwargs)
                    )
                else:
                    self._instance = self.cls(*self.init_args, **self.init_kwargs)
            except BaseException as exc:  # noqa: BLE001
                tb = getattr(exc, "remote_traceback", None) or traceback.format_exc()
                with self._lock:
                    worker, self._worker = self._worker, None
                if worker is not None:
                    worker.kill()
                self._release()
                self._die(f"__init__ raised: {exc}\n{tb}")
                return
            with self._lock:
                self.state = ActorState.ALIVE
            restart = self._serve_mailbox()
            self._release()
            if restart and self.num_restarts < self.max_restarts:
                self.num_restarts += 1
                with self._lock:
                    self.state = ActorState.RESTARTING
                logger.warning(
                    "restarting actor %s (%d/%d)", self.name, self.num_restarts, self.max_restarts
                )
                # single-span trace: restarts are rare and have no caller
                # to parent into, but they must show on the timeline
                from ..util import tracing

                tracing.tracer().record_span(
                    "actor.restart", time.time(), time.time(),
                    lane=f"actor:{self.name}",
                    attrs={"actor": self.name,
                           "actor_id": self.actor_id.hex(),
                           "restart": self.num_restarts,
                           "max_restarts": self.max_restarts},
                    status="ERROR",
                )
                continue
            if restart:
                self._die("exceeded max_restarts")
            return

    def _serve_mailbox(self) -> bool:
        """Process calls until poison. Returns True if death was a restartable
        failure, False for clean termination."""
        executor = (
            ThreadPoolExecutor(max_workers=self.max_concurrency,
                               thread_name_prefix=f"actor-{self.name}")
            if self.max_concurrency > 1 else None
        )
        try:
            while True:
                msg = self._mailbox.get()
                if msg is _POISON:
                    return False
                if isinstance(msg, _RestartSignal):
                    if msg.incarnation >= 0 and msg.incarnation != self._incarnation:
                        continue  # stale: refers to an already-replaced instance
                    if self._fail_inflight_after_restart(msg):
                        return False  # a queued terminate outranks restart
                    return True
                if executor is not None:
                    executor.submit(self._execute, msg)
                else:
                    self._execute(msg)
        finally:
            if executor is not None:
                executor.shutdown(wait=True)

    def _execute(self, call: ActorMethodCall) -> None:
        from ..util import logs as _logs
        from ..util import tracing

        with self._lock:
            self._inflight.append(call)
        exec_span = tracing.tracer().start_span(
            "actor.execute", parent=call.trace_ctx,
            lane=f"actor:{self.name}",
            attrs={"actor": self.name, "method": call.method_name,
                   "task_id": call.task_id.hex()},
        )
        try:
            with tracing.use_context(exec_span.context), \
                    _logs.attribution(
                        f"actor:{self.name}:{call.method_name}"):
                self._execute_inner(call)
        finally:
            exec_span.end()
            with self._lock:
                try:
                    self._inflight.remove(call)
                except ValueError:
                    pass

    def _execute_inner(self, call: ActorMethodCall) -> None:
        try:
            if call.method_name == "__ray_ready__" and self._worker is None:
                result = True
            elif call.method_name == "__ray_pid__" and self._worker is None:
                result = os.getpid()
            else:
                # chaos's boundary for actor calls (tasks inject in the
                # scheduler): serve replicas are actors, so resilience
                # drills arm name_filter=".call" or a deployment's name
                from . import chaos

                chaos.maybe_inject(f"actor:{self.name}.{call.method_name}", node=self._node)
                args = tuple(
                    a.resolve() if getattr(a, "__ray_tpu_lazy__", False) else a
                    for a in call.args
                )
                kwargs = {
                    k: (v.resolve() if getattr(v, "__ray_tpu_lazy__", False) else v)
                    for k, v in call.kwargs.items()
                }
                if call.method_name == "__ray_apply__" and self._worker is None:
                    # fn(instance, *args): runs a function on the instance
                    # inside the actor (reference __ray_call__)
                    fn = args[0]
                    result = fn(self._instance, *args[1:], **kwargs)
                elif self._worker is not None:
                    from .worker_pool import WorkerCrashedError

                    inc = self._incarnation
                    try:
                        with self._worker_lock:
                            result = self._worker.request(
                                "actor_call", (call.method_name, args, kwargs)
                            )
                    except WorkerCrashedError as crash:
                        # the worker died: fail this call as an actor death
                        # and restart, unless the death was an explicit kill
                        # (state already DEAD: no_restart stays final)
                        call.fail(self._store, ActorDiedError(self.actor_id, str(crash)))
                        with self._lock:
                            dead = self.state == ActorState.DEAD
                        if not dead:
                            self._mailbox.put(_RestartSignal(str(crash), inc))
                        return
                else:
                    method = getattr(self._instance, call.method_name)
                    result = method(*args, **kwargs)
            if call.streaming:
                # Generator method: seal each yield into its own dynamic
                # return id and hand it to the consumer stream immediately.
                if not hasattr(result, "__iter__"):
                    raise TypeError(
                        f"{self.name}.{call.method_name} declared "
                        'num_returns="streaming" but returned '
                        f"{type(result).__name__}, not an iterable"
                    )
                for idx, item in enumerate(result):
                    oid = ObjectID.for_task_return(call.task_id, idx)
                    self._store.create(oid)
                    self._store.seal(oid, item)
                    call.return_ids.append(oid)
                    call.stream._append_oid(oid)
                call.stream._finish()
            elif call.num_returns == 1:
                self._store.seal(call.return_ids[0], result)
            else:
                values = list(result)
                if len(values) != call.num_returns:
                    raise ValueError(
                        f"{self.name}.{call.method_name} declared "
                        f"num_returns={call.num_returns} but returned {len(values)} values"
                    )
                for oid, value in zip(call.return_ids, values):
                    self._store.seal(oid, value)
        except BaseException as exc:  # noqa: BLE001 - boundary
            tb = getattr(exc, "remote_traceback", None) or traceback.format_exc()
            err = TaskError(f"{self.name}.{call.method_name}", exc, tb)
            call.fail(self._store, err)

    def _fail_inflight_after_restart(self, signal: "_RestartSignal") -> bool:
        # Drain whatever was queued before the failure; those calls fail.
        # Returns True if a queued terminate (_POISON) was drained — it
        # must not be swallowed.
        poisoned = False
        try:
            while True:
                msg = self._mailbox.get_nowait()
                if msg is _POISON:
                    poisoned = True
                elif isinstance(msg, ActorMethodCall):
                    err = ActorDiedError(self.actor_id, signal.reason)
                    msg.fail(self._store, err)
        except queue.Empty:
            pass
        return poisoned

    def _release(self) -> None:
        if self._pool is not None:
            self._pool.release(self.resources)
        self._node = None
        self._pool = None
        with self._lock:
            worker, self._worker = self._worker, None
        if worker is not None:
            worker.shutdown()
        instance, self._instance = self._instance, None
        # An instance that holds what its collection would free late or
        # never (a card's memory, threads) frees it here, when the actor
        # stops, whoever else still references it.
        hook = getattr(instance, "__ray_shutdown__", None)
        if hook is not None:
            try:
                hook()
            except Exception:  # noqa: BLE001 - teardown must not kill the lifecycle
                logger.exception("actor %s: __ray_shutdown__ raised", self.name)

    def _die(self, reason: str) -> None:
        with self._lock:
            self.state = ActorState.DEAD
            self.death_cause = reason
            inflight = list(self._inflight)
            worker = self._worker  # read under the lock: _release may clear it
        if worker is not None:
            # kill the worker now: a call in flight observes the crash and
            # fails at once instead of waiting for the poison
            worker.kill()
        err = ActorDiedError(self.actor_id, reason)
        for call in inflight:
            call.fail(self._store, err)
        if self._on_death is not None:
            try:
                self._on_death(self)
            except Exception:  # noqa: BLE001 - death cleanup must not mask cause
                pass
        # Fail everything still queued.
        try:
            while True:
                msg = self._mailbox.get_nowait()
                if isinstance(msg, ActorMethodCall):
                    msg.fail(self._store, ActorDiedError(self.actor_id, reason))
        except queue.Empty:
            pass

    # ----------------------------------------------------------------- client

    def submit(self, call: ActorMethodCall) -> None:
        with self._lock:
            if self.state == ActorState.DEAD:
                call.fail(self._store, ActorDiedError(self.actor_id, self.death_cause))
                return
        self._mailbox.put(call)

    def kill(self, no_restart: bool = True, reason: str = "ray_tpu_torch.kill") -> None:
        """Simulates hard death of the actor."""
        if no_restart or self.num_restarts >= self.max_restarts:
            with self._lock:
                if self.state == ActorState.DEAD:
                    return
            self._die(reason)
            self._mailbox.put(_POISON)
        else:
            self._mailbox.put(_RestartSignal(reason))

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the lifecycle thread (and with it the mailbox pool) to
        exit; True when it has."""
        self._thread.join(timeout)
        return not self._thread.is_alive()


@dataclass
class _RestartSignal:
    reason: str = "injected failure"
    # Incarnation that observed the failure. A signal from a previous
    # incarnation is stale and must not kill the restarted instance: with
    # max_concurrency > 1, several in-flight calls can all observe one
    # failure and each enqueue a signal.
    incarnation: int = -1
