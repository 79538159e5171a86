"""The per-process runtime: object refs, task submission, actor management.

Port of `ray_tpu/core/runtime.py` for one process: it owns the object
store, the scheduler over the process's logical nodes, the control store
and the actor registry, and implements put/get/wait/submit_task/
create_actor on top of them. Every task submit and actor call opens a
tracing span (`util/tracing`) that the execution spans on the worker or
actor thread parent into.

Tasks and actors run on threads by default; `executor="process"` runs a
task on a pooled worker process and an actor in a worker process of its
own (`worker_pool.py`), with a `runtime_env` (env_vars, py_modules,
working_dir) exported to it. Thread tasks take env_vars and py_modules,
scoped around their body; thread actors take no runtime_env. The health
manager probes every process actor's worker, so a killed worker is
restarted without waiting for a call, and the memory monitor kills a
busy pooled worker when host memory runs short (`health.py`); both start
with the runtime, and `shutdown()` joins them and stops the pool.

Cluster mode (`core/cluster.py`): `head=True` makes this process a
cluster head (its GCS served over RPC, `gcs_port`), `address=...` joins
one as a node; `cluster_token` authenticates every connection. Tasks then
place on any node (remote ones over RPC), actors may live on node agents
(a proxy handle here), and an ObjectRef crossing processes carries its
owner's address so the receiver borrows it (`_rebind_cluster_ref`).
`shutdown()` leaves the cluster and joins every thread it started.

Placement groups take `max_reschedules` (their rescheduling budget after
a bundle host's death). Announced preemption: `preempt_node(node)` drains
a logical node, announces it on the control store's pub/sub and kills it
after the warning window (its actors restart elsewhere when budgeted,
its groups reschedule); chaos's `preempt_node` mode pulls the same
trigger (`_chaos_preempt`), or a cluster member's `begin_preemption`
when the whole process is the target. `RAY_TPU_CHAOS` is read at init.

What the JAX runtime also does and the port does not yet — each raises
NotImplementedError naming its ROADMAP item where a caller can ask for
it: GCS snapshots, the WAL and a restarted head's reconciliation (A6b,
head restart), jobs (A6b) and `profile_capture`'s fan-out to node agents
(A6b, federation: here one local capture covers every selected logical
node, as JAX's in-process runtime does).
"""

from __future__ import annotations

import atexit
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .actors import ActorMethodCall, ActorRuntime, ActorState
from .exceptions import RuntimeNotInitializedError
from .gcs import GlobalControlStore
from .ids import ActorID, JobID, NodeID, ObjectID, TaskID
from .object_store import ObjectStore
from .resources import ResourceDict, default_node_resources
from .scheduler import ClusterScheduler, Node, PlacementGroup, TaskSpec
from .streaming import ObjectRefGenerator



class ObjectRef:
    """A future handle to an object in the store.

    Handles are counted: construction increfs, __del__ decrefs, and when
    the last handle dies the store releases the value (auto-GC). A GC'd
    object with recorded lineage is reconstructed on a later get()."""

    __slots__ = ("object_id", "_runtime", "__weakref__")

    def __init__(self, object_id: ObjectID, runtime: "Runtime"):
        self.object_id = object_id
        self._runtime = runtime
        runtime.object_store.incref(object_id)

    def __del__(self):
        try:
            self._runtime.object_store.decref(self.object_id)
        except Exception:
            pass  # interpreter teardown: modules may already be gone

    def hex(self) -> str:
        return self.object_id.hex()

    def is_ready(self) -> bool:
        return self._runtime.object_store.is_ready(self.object_id)

    def task_id(self) -> TaskID:
        return self.object_id.task_id()

    def __hash__(self):
        return hash(self.object_id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.object_id == self.object_id

    def __repr__(self):
        return f"ObjectRef({self.object_id.hex()})"

    def __reduce__(self):
        # In a cluster the ref carries its OWNER's node address, so the
        # receiving process becomes a registered BORROWER: it pins the
        # value at the owner until its copy of the ref dies.
        ctx = getattr(self._runtime, "cluster", None)
        if ctx is not None:
            from .object_store import Tier

            entry = self._runtime.object_store.entry(self.object_id)
            owner = (entry.owner_addr if entry is not None and entry.owner_addr
                     else ctx.address)  # a borrowed ref chains to its owner
            # arg locality: when the value lives on ANOTHER node (a REMOTE
            # placeholder), ship that location so the receiver pulls
            # peer-to-peer instead of through the owner
            location = None
            if entry is not None and entry.tier == Tier.REMOTE and isinstance(entry.value, str):
                location = entry.value
            return (_rebind_cluster_ref, (self.object_id.hex(), owner, location))
        return (_rebind_object_ref, (self.object_id.hex(),))


def _rebind_object_ref(hex_id: str) -> "ObjectRef":
    rt = get_runtime()
    return ObjectRef(ObjectID(hex_id), rt)


def _rebind_cluster_ref(hex_id: str, owner_addr: str,
                        location: "Optional[str]" = None) -> "ObjectRef":
    rt = get_runtime()
    oid = ObjectID(hex_id)
    ctx = rt.cluster
    if ctx is not None and owner_addr != ctx.address:
        store = rt.object_store
        entry = store.entry(oid)
        if entry is None:
            entry = store.create(oid)
            entry.foreign = True
        # register the borrow even when a sealed LOCAL copy exists (this
        # agent holds the task's result): without the pin the owner's last
        # handle dying would free our copy while this ref lives. One
        # borrow per (process, object).
        if entry.owner_addr is None:
            entry.owner_addr = owner_addr
            if location and location != ctx.address:
                entry.fetch_addr = location  # pull from where the bytes ARE
            ctx.enqueue_borrow(oid, owner_addr)
    return ObjectRef(oid, rt)


class Runtime:
    """A single in-process 'cluster': nodes, scheduler, store, control plane."""

    def __init__(
        self,
        num_cpus: Optional[int] = None,
        num_gpus: Optional[int] = None,
        resources: Optional[ResourceDict] = None,
        num_nodes: int = 1,
        object_store_capacity: Optional[int] = None,
        spill_dir: Optional[str] = None,
        detect_accelerators: bool = True,
        labels: "Optional[Dict[str, str]]" = None,
        head: bool = False,
        address: Optional[str] = None,
        cluster_token: Optional[str] = None,
        gcs_port: int = 0,
    ):
        from .config import cfg

        if head and address:
            raise ValueError("pass either head=True or address=..., not both")
        if object_store_capacity is None:
            object_store_capacity = cfg.object_store_capacity_bytes
        if spill_dir is None:
            spill_dir = cfg.spill_dir or None
        self.job_id = JobID.next()
        self.gcs = GlobalControlStore()
        self.object_store = ObjectStore(object_store_capacity, spill_dir=spill_dir)
        self.scheduler = ClusterScheduler(self.object_store, self._on_task_done)
        # lineage: a get() of a LOST object re-executes its creating task
        self.object_store.set_resubmit(self.scheduler.submit)
        self._actors: Dict[ActorID, ActorRuntime] = {}
        self._lock = threading.Lock()
        # completion log appended by scheduler worker threads; its own
        # lock so readers never contend with the actor table
        self._task_events_lock = threading.Lock()
        self._task_events: List[Dict[str, Any]] = []  # guarded-by: _task_events_lock
        node_res = default_node_resources(
            num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
            detect_accelerators=detect_accelerators,
        )
        for i in range(num_nodes):
            self.scheduler.add_node(
                Node(NodeID.from_random(), dict(node_res), is_head=(i == 0),
                     labels=dict(labels or {}))
            )
        # failure detection and the OOM policy (flag-driven)
        from .health import HealthCheckManager, MemoryMonitor

        self.health = HealthCheckManager(cfg.health_check_period_s, cfg.health_check_failures)
        self.health.start()
        self.memory_monitor = MemoryMonitor(
            cfg.memory_usage_threshold, cfg.memory_monitor_interval_s, cfg.oom_policy,
        )
        self.memory_monitor.start()
        # log capture: the tail of this process's logging stream, with
        # the head node's id on every record
        from ..util import logs as _logs

        _logs.install()
        _logs.set_node_id(self.scheduler.head_node().node_id.hex())
        # runtime gauges (scrape-time sampling) and the registry of
        # profile captures (filled by profile_capture below)
        from ..util import profiling as _profiling
        from ..util.metrics import register_runtime_gauges

        register_runtime_gauges()
        self.profiles = _profiling.ProfileStore()
        # announced preemption: chaos (preempt_node) and an agent's SIGTERM
        # pull the trigger; this runtime drains, announces and kills
        from . import chaos as _chaos

        self._preempt_timers: List[threading.Timer] = []  # guarded-by: _lock
        _chaos.set_preemption_hook(self._chaos_preempt)
        # multi-process cluster membership (core/cluster.py): the head
        # serves its GCS over RPC; a node joins an existing head. Either way
        # this process gains a node server and remote dispatch.
        self.cluster = None
        if head or address:
            from .cluster import join_cluster, start_head

            try:
                if head:
                    self.cluster = start_head(self, port=gcs_port, token=cluster_token)
                else:
                    self.cluster = join_cluster(self, address, token=cluster_token)
            except BaseException:
                self.shutdown()
                raise

    # ------------------------------------------------------------------ store

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.for_put(self.job_id)
        self.object_store.put(oid, value)
        return ObjectRef(oid, self)

    def get(
        self,
        refs: Union[ObjectRef, Sequence[ObjectRef]],
        timeout: Optional[float] = None,
    ) -> Any:
        if isinstance(refs, ObjectRef):
            return self.object_store.get(refs.object_id, timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            out.append(self.object_store.get(ref.object_id, remaining))
        return out

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int = 1,
        timeout: Optional[float] = None,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        if num_returns == 0:
            # nothing to wait for: the per-ref ready callbacks below are
            # the only thing that sets the event, so an empty wait would
            # otherwise block forever
            return [], list(refs)
        done_event = threading.Event()
        ready_count = [0]
        lock = threading.Lock()

        def _cb(_entry):
            with lock:
                ready_count[0] += 1
                if ready_count[0] >= num_returns:
                    done_event.set()

        for ref in refs:
            self.object_store.add_ready_callback(ref.object_id, _cb)
        done_event.wait(timeout)
        for ref in refs:
            self.object_store.remove_ready_callback(ref.object_id, _cb)
        ready_all: List[ObjectRef] = []
        not_ready: List[ObjectRef] = []
        for r in refs:
            (ready_all if self.object_store.is_ready(r.object_id) else not_ready).append(r)
        # at most num_returns refs in the ready list; surplus ready refs
        # stay in the second list, order preserved
        ready = ready_all[:num_returns]
        second_ids = {r.object_id for r in ready_all[num_returns:]}
        second_ids.update(r.object_id for r in not_ready)
        return ready, [r for r in refs if r.object_id in second_ids]

    # ------------------------------------------------------------------ tasks

    def submit_task(
        self,
        func,
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        name: str = "",
        num_returns: Union[int, str] = 1,
        resources: Optional[ResourceDict] = None,
        max_retries: int = 0,
        retry_exceptions: Any = False,
        scheduling_strategy: Any = "DEFAULT",
        runtime_env: Any = None,
        executor: str = "thread",
        stream_max_backlog: Optional[int] = None,
        locality_hint: Any = None,
    ) -> Union[ObjectRef, List[ObjectRef], "ObjectRefGenerator"]:
        from . import runtime_env as _renv

        streaming = num_returns == "streaming"
        if executor not in ("thread", "process"):
            raise ValueError(f"executor must be 'thread' or 'process', not {executor!r}")
        if streaming and executor == "process":
            raise ValueError(
                'num_returns="streaming" requires the thread executor: a '
                "process worker returns one pickled result, not a live stream"
            )
        renv = _renv.normalize(runtime_env)
        if renv and renv.get("working_dir") and executor != "process":
            raise ValueError(
                'runtime_env["working_dir"] requires executor="process": a '
                "thread task cannot change the process-global cwd safely"
            )
        if executor == "process":
            from .worker_pool import check_importable

            check_importable(func, "a process task's function")
        local_only = self.cluster is not None and not self._exportable(
            func, "a task's function", scheduling_strategy)
        task_id = TaskID.of(self.job_id)
        n_static = 0 if streaming else num_returns
        return_ids = [ObjectID.for_task_return(task_id, i) for i in range(n_static)]
        spec = TaskSpec(
            task_id=task_id,
            name=name or getattr(func, "__name__", "task"),
            func=func,
            args=args,
            kwargs=kwargs,
            num_returns=n_static,
            resources=dict(resources or {"CPU": 1.0}),
            max_retries=max_retries,
            retry_exceptions=retry_exceptions,
            scheduling_strategy=scheduling_strategy,
            return_ids=return_ids,
            runtime_env=renv,
            executor=executor,
            streaming=streaming,
            stream_max_backlog=stream_max_backlog,
            locality_hint=locality_hint,
            local_only=local_only,
        )
        if streaming:
            import weakref

            gen = ObjectRefGenerator(task_id, self)
            spec.stream = weakref.ref(gen)
        # Tracing root (or child, when submitted from inside a traced
        # region — another task, a serve request): every downstream
        # queue/execute/result span shares this trace_id.
        from ..util import tracing

        submit_span = tracing.tracer().start_span(
            "task.submit",
            attrs={"task": spec.name, "task_id": task_id.hex()},
        )
        spec.trace_ctx = submit_span.context
        for oid in return_ids:
            self.object_store.create(oid, owner_task=spec)
        self.scheduler.submit(spec)
        submit_span.end()
        if streaming:
            return gen
        refs = [ObjectRef(oid, self) for oid in return_ids]
        return refs[0] if num_returns == 1 else refs

    def _exportable(self, obj, what: str, strategy) -> bool:
        """Whether a node agent could import `obj` (a task's function or an
        actor's class: the wire pickles it by reference). One that cannot
        stays on this process's nodes; pinning it hard to a remote node
        raises TypeError, naming the rule."""
        from .scheduler import NodeAffinitySchedulingStrategy
        from .worker_pool import check_importable

        try:
            check_importable(obj, what)
            return True
        except TypeError as exc:
            if (isinstance(strategy, NodeAffinitySchedulingStrategy) and not strategy.soft
                    and any(n.is_remote and n.node_id == strategy.node_id
                            for n in self.scheduler.nodes())):
                raise TypeError(
                    f"{exc} — a node agent imports it by reference, so it cannot be "
                    f"pinned to remote node {strategy.node_id.hex()[:12]}") from None
            return False

    def cancel(self, ref: ObjectRef) -> bool:
        return self.scheduler.cancel(ref.object_id.task_id())

    def _on_task_done(self, spec: TaskSpec, error: Optional[BaseException]) -> None:
        event = {
            "task_id": spec.task_id.hex(),
            "name": spec.name,
            "ok": error is None,
            "attempt": spec.attempt,
            "ts": time.time(),
            "start_ts": spec.start_ts,
            "end_ts": spec.end_ts or time.time(),
            "node": spec.node_hex,
        }
        with self._task_events_lock:
            self._task_events.append(event)
            if len(self._task_events) > 100_000:
                del self._task_events[:50_000]

    # ----------------------------------------------------------------- actors

    def create_actor(
        self,
        cls: type,
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        resources: Optional[ResourceDict] = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        name: Optional[str] = None,
        namespace: str = "default",
        scheduling_strategy: Any = "DEFAULT",
        lifetime: Optional[str] = None,
        executor: str = "thread",
        runtime_env: Any = None,
        placement_pool: Any = None,
        _hosted: bool = False,
    ) -> "ActorHandle":
        """`_hosted`: a node agent creating an actor for a remote owner
        (core/cluster.py), which always lives in this process;
        `placement_pool` is then the reserved pool of the bundle the owner
        placed it in."""
        from . import runtime_env as _renv

        if executor not in ("thread", "process"):
            raise ValueError(f"executor must be 'thread' or 'process', not {executor!r}")
        renv = _renv.normalize(runtime_env)
        if renv and executor != "process":
            raise ValueError(
                "actor runtime_env requires executor='process' (thread "
                "actors share the caller's process environment)"
            )
        if executor == "process":
            from .worker_pool import check_importable

            check_importable(cls, "a process actor's class")
        # cluster placement: NodeAffinity to a remote node, or spillover
        # when only a remote node can take it — the agent hosts the actor,
        # this process keeps a proxy (core/cluster.py RemoteActorProxy)
        if self.cluster is not None and not _hosted and placement_pool is None:
            res = dict(resources or {"CPU": 1.0})
            placed = self.cluster.can_place_actor_remotely(scheduling_strategy, res)
            if placed is not None and self._exportable(cls, "an actor's class",
                                                       scheduling_strategy):
                return self._create_remote_actor(placed, cls, args, kwargs, res, max_restarts,
                                                 max_concurrency, name, namespace, executor,
                                                 renv)
        actor_id = ActorID.of(self.job_id)
        handle = ActorHandle(actor_id, self)
        # Reserve the name BEFORE spawning the actor so a duplicate name
        # raises without leaking a live, resource-holding actor.
        if name:
            self.gcs.register_named_actor(name, handle, namespace=namespace)

        def _on_death(rt: ActorRuntime) -> None:
            # Release the name when the actor dies on its own (init failure,
            # unschedulable, restarts exhausted) — not just on explicit kill.
            if rt.registered_name:
                self.gcs.unregister_named_actor(rt.registered_name, rt.registered_namespace)
            # stop probing a dead actor (and drop the closure pinning it)
            target = getattr(rt, "_health_target", None)
            if target is not None:
                self.health.unregister(target)

        try:
            runtime = ActorRuntime(
                actor_id=actor_id,
                cls=cls,
                init_args=args,
                init_kwargs=kwargs,
                resources=dict(resources or {"CPU": 1.0}),
                scheduler=self.scheduler,
                object_store=self.object_store,
                scheduling_strategy=scheduling_strategy,
                max_restarts=max_restarts,
                max_concurrency=max_concurrency,
                name=name or cls.__name__,
                on_death=_on_death,
                registered_name=name,
                registered_namespace=namespace,
                executor=executor,
                runtime_env=renv,
                placement_pool=placement_pool,
            )
        except BaseException:
            if name:
                self.gcs.unregister_named_actor(name, namespace=namespace)
            raise
        with self._lock:
            self._actors[actor_id] = runtime
        if executor == "process":
            self._register_actor_health(actor_id, runtime)
        return handle

    def _create_remote_actor(self, placed, cls, args, kwargs, res, max_restarts,
                             max_concurrency, name, namespace, executor, renv) -> "ActorHandle":
        node, pool, bundle = placed
        actor_id, proxy = self.cluster.create_remote_actor(
            node, cls, args, kwargs, resources=res, max_restarts=max_restarts,
            max_concurrency=max_concurrency, name=name, namespace=namespace,
            executor=executor, runtime_env=renv, pool=pool, bundle=bundle,
        )
        handle = ActorHandle(actor_id, self)
        if name:
            # reserve the name here too (a duplicate raises without leaking
            # a live remote actor); proxy.die releases it
            try:
                self.gcs.register_named_actor(name, handle, namespace=namespace)
            except BaseException:
                self.cluster.kill_remote_actor(proxy)
                raise
            proxy.registered_name = name
            proxy.registered_namespace = namespace
        return handle

    def _remote_actor_proxy(self, actor_id: ActorID):
        if self.cluster is None:
            return None
        with self.cluster._lock:
            return self.cluster.remote_actors.get(actor_id)

    def _register_actor_health(self, actor_id: ActorID, rt: ActorRuntime) -> None:
        """Probe a process actor's worker, so a killed or crashed worker is
        detected and restarted WITHOUT waiting for the next method call."""
        from .actors import _RestartSignal

        target = f"actor:{actor_id.hex()[:12]}:{rt.name}"
        rt._health_target = target  # unregistered by the on_death hook

        def probe() -> bool:
            if rt.state != ActorState.ALIVE:
                return True  # pending / restarting / dead: nothing to detect
            worker = rt._worker
            return worker is None or worker.alive()

        def on_dead(_tid: str) -> None:
            with rt._lock:
                dead = rt.state == ActorState.DEAD
            if not dead:
                rt._mailbox.put(
                    _RestartSignal("health check: worker process died", rt._incarnation)
                )
                # re-arm: the restarted incarnation is probed too
                self.health.register(target, probe, on_dead)

        self.health.register(target, probe, on_dead)

    def actor_runtime(self, actor_id: ActorID) -> ActorRuntime:
        with self._lock:
            return self._actors[actor_id]

    def actor_state(self, actor_id: ActorID) -> ActorState:
        """State of a local actor or a cluster-hosted one (asked of the
        hosting agent over RPC)."""
        with self._lock:
            rt = self._actors.get(actor_id)
        if rt is not None:
            return rt.state
        proxy = self._remote_actor_proxy(actor_id)
        if proxy is None:
            raise KeyError(actor_id)
        if proxy.state == "DEAD":
            return ActorState.DEAD
        if proxy.state in ("PENDING", "RESTARTING"):
            return ActorState(proxy.state)
        try:
            return ActorState(proxy.node.client.call("actor_state", actor_id.hex()))
        except Exception:
            return ActorState.DEAD

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        num_returns: Union[int, str] = 1,
    ) -> Union[ObjectRef, List[ObjectRef], "ObjectRefGenerator"]:
        from ..util import tracing

        proxy = self._remote_actor_proxy(actor_id)
        if proxy is not None:
            if num_returns == "streaming":
                raise ValueError(
                    'num_returns="streaming" is not supported on cluster-hosted '
                    "actors (streams need a live in-process queue)"
                )
            r_task_id = TaskID.of(self.job_id)
            return_ids = [ObjectID.for_task_return(r_task_id, i) for i in range(num_returns)]
            for oid in return_ids:
                self.object_store.create(oid)
            call_span = tracing.tracer().start_span(
                "actor.call",
                attrs={"actor": proxy.display_name, "method": method_name,
                       "task_id": r_task_id.hex(), "remote": True},
            )
            self.cluster.submit_remote_actor_call(proxy, method_name, args, kwargs,
                                                  return_ids, trace_ctx=call_span.context)
            call_span.end()
            refs = [ObjectRef(oid, self) for oid in return_ids]
            return refs[0] if num_returns == 1 else refs
        task_id = TaskID.of(self.job_id)
        streaming = num_returns == "streaming"
        n_static = 0 if streaming else num_returns
        return_ids = [ObjectID.for_task_return(task_id, i) for i in range(n_static)]
        for oid in return_ids:
            self.object_store.create(oid)
        rt = self.actor_runtime(actor_id)
        call_span = tracing.tracer().start_span(
            "actor.call",
            attrs={"actor": rt.name, "method": method_name,
                   "task_id": task_id.hex()},
        )
        call = ActorMethodCall(
            task_id=task_id,
            method_name=method_name,
            args=self._materialize_args(args),
            kwargs=self._materialize_kwargs(kwargs),
            return_ids=return_ids,
            num_returns=n_static,
            streaming=streaming,
            stream=ObjectRefGenerator(task_id, self) if streaming else None,
            trace_ctx=call_span.context,
        )
        rt.submit(call)
        call_span.end()
        if streaming:
            return call.stream
        refs = [ObjectRef(oid, self) for oid in return_ids]
        return refs[0] if num_returns == 1 else refs

    def _materialize_args(self, args):
        # Actor calls resolve ObjectRef args lazily inside the actor thread to
        # preserve submission ordering; we wrap them so the executor resolves.
        return tuple(_LazyRef(a, self) if isinstance(a, ObjectRef) else a for a in args)

    def _materialize_kwargs(self, kwargs):
        return {
            k: _LazyRef(v, self) if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()
        }

    def kill_actor(self, handle: "ActorHandle", no_restart: bool = True) -> None:
        proxy = self._remote_actor_proxy(handle._actor_id)
        if proxy is not None:
            self.cluster.kill_remote_actor(proxy)
            return
        rt = self.actor_runtime(handle._actor_id)
        rt.kill(no_restart=no_restart)
        if no_restart and getattr(rt, "registered_name", None):
            self.gcs.unregister_named_actor(rt.registered_name, rt.registered_namespace)

    def get_actor(self, name: str, namespace: str = "default") -> "ActorHandle":
        handle = self.gcs.get_named_actor(name, namespace)
        if handle is not None:
            return handle
        if self.cluster is not None:
            # the cluster-wide directory: an actor named by ANY driver on
            # ANY node resolves to a proxy handle here
            proxy = self.cluster.lookup_named_actor(name, namespace)
            if proxy is not None:
                return ActorHandle(proxy.actor_id, self)
        raise ValueError(f"No actor named {name!r} in namespace {namespace!r}")

    def list_actors(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = [
                {
                    "actor_id": aid.hex(),
                    "name": rt.name,
                    "state": rt.state.value,
                    "restarts": rt.num_restarts,
                }
                for aid, rt in self._actors.items()
            ]
        if self.cluster is not None:
            with self.cluster._lock:
                proxies = list(self.cluster.remote_actors.items())
            for aid, proxy in proxies:
                out.append({
                    "actor_id": aid.hex(),
                    "name": proxy.display_name,
                    "state": proxy.state,
                    "restarts": proxy.restarts_used,
                    "node": proxy.node.node_id.hex() if proxy.node else None,
                })
        return out

    # ------------------------------------------------------------- placement

    def create_placement_group(self, bundles, strategy="PACK", name="",
                               max_reschedules=None) -> PlacementGroup:
        return self.scheduler.create_placement_group(
            bundles, strategy, name, max_reschedules=max_reschedules)

    def remove_placement_group(self, pg: PlacementGroup) -> None:
        self.scheduler.remove_placement_group(pg)

    # ---------------------------------------------------------------- cluster

    def cluster_resources(self) -> ResourceDict:
        return self.scheduler.cluster_resources()

    def available_resources(self) -> ResourceDict:
        return self.scheduler.available_resources()

    def task_events(self) -> List[Dict[str, Any]]:
        with self._task_events_lock:
            return list(self._task_events)

    def node_of_task(self, task_id_hex: str) -> Optional[str]:
        """node_hex that executed a task (latest attempt wins), or None."""
        with self._task_events_lock:
            events = list(self._task_events)
        for ev in reversed(events):
            if ev["task_id"] == task_id_hex:
                return ev["node"] or None
        return None

    # -------------------------------------------------------------- profiling

    def profile_capture(
        self,
        nodes: Optional[Sequence[str]] = None,
        duration_s: Optional[float] = None,
        device: bool = True,
        host: bool = True,
    ) -> Dict[str, Any]:
        """A time-boxed device trace + host sampling profile over the
        selected logical nodes (hex prefixes; None = every alive node),
        registered in the profile store and the control store's
        `_profiles` table so `state.list_profiles()` and `trace_dump`
        reach it. The logical nodes share this process, so one local
        capture covers every selected node (the non-head entries
        reference the head's artifacts), as in JAX's in-process branch;
        the fan-out to node agents comes with ROADMAP A6b (federation)."""
        import os as _os

        from ..util import profiling as _profiling
        from .config import cfg
        from .gcs import PROFILE_NS

        if duration_s is None:
            duration_s = cfg.profile_default_duration_s
        profile_id = _os.urandom(6).hex()

        def selected(node_hex: str) -> bool:
            return not nodes or any(node_hex.startswith(p) for p in nodes)

        started_at = time.time()
        head_hex = self.scheduler.head_node().node_id.hex()
        chosen = [n.node_id.hex() for n in self.scheduler.nodes()
                  if n.alive and selected(n.node_id.hex())]
        if not chosen:
            raise ValueError(f"no alive node matches the capture selector {nodes!r}")
        local = _profiling.capture_local_profile(
            duration_s, device=device, host=host, profile_id=profile_id)
        artifact_hex = head_hex if head_hex in chosen else chosen[0]
        blobs: Dict[Tuple[str, str], bytes] = {
            (artifact_hex, name): data for name, data in local["artifacts"].items()}
        node_metas: Dict[str, Dict[str, Any]] = {}
        for node_hex in chosen:
            meta = dict(local["meta"])
            if node_hex != artifact_hex:
                meta["artifacts_at"] = artifact_hex
                meta["artifact_names"] = []
            node_metas[node_hex] = meta
        record = {
            "profile_id": profile_id,
            "started_at": started_at,
            "duration_s": duration_s,
            "device": device,
            "host": host,
            "nodes": node_metas,
            "total_bytes": sum(len(b) for b in blobs.values()),
        }
        self.profiles.add(record, blobs)
        self.gcs.kv.put(profile_id, record, namespace=PROFILE_NS)
        return record

    # ------------------------------------------------------------- preemption

    def _chaos_preempt(self, node, warning_s: float, reason: str) -> None:
        """Chaos's preempt_node trigger. `node` is the logical node the
        matching task ran on; None (or a remote node's view) means the
        injection fired at an agent boundary, and the whole PROCESS is the
        target."""
        if node is None or getattr(node, "is_remote", False):
            if self.cluster is not None:
                # a cluster member: announce through the head's GCS, drain,
                # and exit after the window (a spot host's fate)
                self.cluster.begin_preemption(reason, warning_s, fate="exit")
                return
            node = self.scheduler.head_node()
        self.preempt_node(node, warning_s=warning_s, reason=reason)

    def preempt_node(self, node: Node, warning_s: Optional[float] = None,
                     reason: str = "preempted") -> None:
        """Put a logical node of this process into PREEMPTING: placement
        stops at once, the notice goes out on the control store's pub/sub
        (PREEMPT_CHANNEL) for train controllers, and after `warning_s` the
        node dies, so running work gets the window to checkpoint."""
        from .config import cfg
        from .gcs import PREEMPT_CHANNEL

        if warning_s is None:
            warning_s = cfg.preempt_warning_s
        deadline = time.time() + warning_s
        marked = self.scheduler.mark_node_draining(node.node_id.hex(), reason, deadline)
        if marked is None or not node.alive:
            return  # unknown or already gone
        from ..util.events import emit

        emit("WARNING", "cluster",
             f"node {node.node_id.hex()[:12]} preempting: {reason} ({warning_s:.1f}s warning)",
             kind="preempt.announced", node=node.node_id.hex(),
             deadline=deadline, warning_s=warning_s)
        self.gcs.pubsub.publish(PREEMPT_CHANNEL, {
            "node_hex": node.node_id.hex(), "reason": reason,
            "warning_s": warning_s, "deadline": deadline,
        })
        timer = threading.Timer(warning_s, self._kill_local_node, args=(node, reason))
        timer.daemon = True
        with self._lock:
            self._preempt_timers.append(timer)
        timer.start()

    def _kill_local_node(self, node: Node, reason: str) -> None:
        """The warning window closed: the preempted node is gone. Its
        actors die (restarting elsewhere when budgeted: the node is out of
        every placement path already) and its placement groups
        reschedule."""
        if not node.alive:
            return
        from ..util.events import emit

        node_hex = node.node_id.hex()
        emit("WARNING", "cluster",
             f"preempted node {node_hex[:12]} died after its warning window",
             kind="node.preempt_expired", node=node_hex, reason=reason)
        emit("ERROR", "cluster", f"node {node_hex[:12]} is dead (preempted: {reason})",
             kind="node.dead", node=node_hex, reason=reason)
        self.scheduler.remove_node(node.node_id)
        with self._lock:
            doomed = [ar for ar in self._actors.values() if ar._node is node]
        for ar in doomed:
            ar.kill(no_restart=False, reason=f"node {node_hex[:12]} preempted: {reason}")
        self.scheduler.handle_node_death(node_hex, f"preempted: {reason}")

    def shutdown(self) -> None:
        """Stop the health manager and the memory monitor (joining their
        threads), kill every actor and join its thread, stop the scheduler
        and join its dispatch and task threads, then stop the worker pool
        and unmap the object store's arena. A cluster member first leaves
        the cluster (`ClusterContext.stop`, which joins its threads) and a
        head stops serving its GCS."""
        from . import chaos as _chaos

        _chaos.set_preemption_hook(None)
        with self._lock:
            timers, self._preempt_timers = getattr(self, "_preempt_timers", []), []
        for timer in timers:
            timer.cancel()
        cluster, self.cluster = getattr(self, "cluster", None), None
        if cluster is not None:
            cluster.stop()
            gcs_server = getattr(cluster, "gcs_server", None)
            if gcs_server is not None:
                gcs_server.stop()
        self.health.stop()
        self.memory_monitor.stop()
        with self._lock:
            actors = list(self._actors.values())
        for rt in actors:
            rt.kill(no_restart=True, reason="runtime shutdown")
        deadline = time.monotonic() + 30.0
        for rt in actors:
            rt.join(timeout=max(0.0, deadline - time.monotonic()))
        self.scheduler.shutdown()
        from .worker_pool import shutdown_worker_pool

        shutdown_worker_pool()
        self.object_store.close_arena()


class _LazyRef:
    """Marker for an ObjectRef arg of an actor call, resolved at execution.
    Holds the originating ObjectRef so the arg cannot be GC'd between
    submission and execution."""

    __slots__ = ("object_id", "_runtime", "_pin")
    __ray_tpu_lazy__ = True

    def __init__(self, ref: "ObjectRef", runtime: Runtime):
        self.object_id = ref.object_id
        self._runtime = runtime
        self._pin = ref

    def resolve(self):
        return self._runtime.object_store.get(self.object_id)


class ActorHandle:
    """Client-side handle; `handle.method.remote(...)` submits a mailbox call."""

    def __init__(self, actor_id: ActorID, runtime: Runtime):
        self._actor_id = actor_id
        self._runtime = runtime

    def __getattr__(self, item: str) -> "ActorMethod":
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item)

    @property
    def __ray_ready__(self) -> "ActorMethod":
        return ActorMethod(self, "__ray_ready__")

    @property
    def __ray_pid__(self) -> "ActorMethod":
        """OS pid of the process executing this actor's methods."""
        return ActorMethod(self, "__ray_pid__")

    @property
    def __ray_apply__(self) -> "ActorMethod":
        """Run fn(instance, *args) inside the actor: the compiled graph's
        loop entry point."""
        return ActorMethod(self, "__ray_apply__")

    def state(self) -> ActorState:
        return self._runtime.actor_state(self._actor_id)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"


class ActorMethod:
    def __init__(self, handle: ActorHandle, name: str, num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, num_returns)

    def remote(self, *args, **kwargs):
        return self._handle._runtime.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs, self._num_returns
        )

    def bind(self, *args, **kwargs):
        """Bind this method into a compiled graph (`experimental/dag.py`);
        compile with .experimental_compile() on the leaf node."""
        from ..experimental.dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)


# --------------------------------------------------------------------- globals

_global_runtime: Optional[Runtime] = None
_global_lock = threading.Lock()


def init_runtime(**kwargs) -> Runtime:
    global _global_runtime
    with _global_lock:
        if _global_runtime is None:
            # RAY_TPU_CHAOS arms at process start, so a spawned node agent
            # carries e.g. a kill_node injection before any task arrives
            from . import chaos

            chaos.load_from_env()
            _global_runtime = Runtime(**kwargs)
        return _global_runtime


def get_runtime() -> Runtime:
    if _global_runtime is None:
        raise RuntimeNotInitializedError(
            "ray_tpu_torch.init() has not been called (and auto-init is disabled here)"
        )
    return _global_runtime


def get_or_init_runtime() -> Runtime:
    if _global_runtime is None:
        return init_runtime()
    return _global_runtime


def is_initialized() -> bool:
    return _global_runtime is not None


def head_outage_s() -> float:
    """Seconds the GCS head has been unreachable from this process (0.0 =
    reachable, no cluster, or no runtime). Control loops key their
    degraded-mode behavior off this probe."""
    cluster = getattr(_global_runtime, "cluster", None)
    if cluster is None:
        return 0.0
    try:
        return cluster.gcs.outage_s()
    except Exception:  # noqa: BLE001 - a liveness probe must never throw
        return 0.0


def shutdown_runtime() -> None:
    global _global_runtime
    with _global_lock:
        if _global_runtime is not None:
            _global_runtime.shutdown()
            _global_runtime = None


atexit.register(shutdown_runtime)
