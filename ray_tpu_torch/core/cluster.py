"""Cluster composition: node agents that join one ray_tpu_torch cluster.

Port of `ray_tpu/core/cluster.py`'s `ClusterContext`: the layer that
turns RPC (`rpc.py`), the GCS service (`gcs_service.py`), chunked object
transfer (`object_transfer.py`) and the process worker pools into ONE
cluster spanning OS processes and hosts.

- **Every member is symmetric.** A member is a Runtime plus one RPC
  server (the node's well-known address) carrying both the object
  transfer plane and the agent control plane (execute_task, task_done,
  free_object, ...). The head additionally serves the GCS.
- **Ownership stays with the submitter.** A task dispatched to a remote
  node keeps its return ObjectIDs owned by the submitting process. Small
  results ride back inside the completion report itself (task_done's
  "value" statuses); large ones stay in the executing node's store
  (custodial), registered in the GCS object directory, and `get()` pulls
  them through `fetch_object` on first access.
- **Scheduling is owner-local.** Each driver schedules its own tasks
  against the cluster view it assembles from GCS heartbeats; an agent
  admits against its OWN ledger (the resource set its local scheduler
  draws from), queues what it cannot run yet (bounded) and bounces the
  rest back ("busy"), so two drivers cannot oversubscribe it.
- **Liveness is heartbeat staleness.** Nodes report resources every
  `node_heartbeat_s`; a node absent from the aggregated view for
  `node_stale_s` is declared dead: its tasks resubmit (system-failure
  budget), its actors restart elsewhere under `max_restarts` or die, and
  its objects flip LOST on the next fetch (lineage re-executes them).
- **Completions survive an unreachable owner.** An agent retries the
  delivery `result_delivery_attempts` times, then PARKS the completion;
  the owner's poll loop claims it (`poll_task_done`).

Actors place remotely too (`RemoteActorProxy`): ordered method calls over
RPC, a cluster-wide named-actor directory (`ACTOR_NS`), ActorDiedError on
node loss, restarts on a surviving node under `max_restarts`. An
ObjectRef crossing processes registers a BORROW at its owner (the
borrow / unborrow handlers), pinning the value there until the
borrower's copy dies.

What differs from JAX, and why:
- A small result travels inside task_done (actor_task_done,
  stream_item), where JAX pushes it first through the chunked transfer
  (push_begin / push_chunk / push_end) and reports after: one RPC instead
  of four, and the owner releases the task's reservation on the node's
  view BEFORE it seals the value, so a caller woken by the value never
  sees the node still busy with the task that produced it.
- What crosses the wire is pickled with the standard pickle by reference
  (`rpc.dumps`, with its tensor reducer) where JAX uses cloudpickle: a
  task's function or an actor's class must be importable by the agent.
  One that `worker_pool.check_importable` refuses stays on the
  submitting node (`TaskSpec.local_only`); pinning it to another node
  raises TypeError at submission.
- Membership refuses to mix packages: the port's head advertises
  `PORT_PROTOCOL` ("torch-1") under `PROTO_NS`, where a JAX head writes
  its integer protocol 1, so a JAX node dialing a port head fails at
  JAX's own check and a port node refuses a JAX head, naming both.

Placement groups span agents: the owner reserves each remote bundle at
its agent in a second phase (`reserve_bundle`, against the agent's own
ledger; a refusal rolls the whole group back), tasks and actors aimed at
a remote bundle lease from the agent's reserved pool, and a released
bundle returns exactly what is unused at once and the rest as its
holders finish. A bundle host's death reschedules the group
(`scheduler.handle_node_death`); a bundle actor with restarts left waits
for the re-reservation and restarts on the bundle's new host. The
owner's view of each group's state goes to the GCS table `PG_NS`.

Announced preemption: `begin_preemption` (SIGTERM to an agent, or chaos
`preempt_node` on it) publishes the notice on the GCS pub/sub and in the
node table, drains the node, and after the warning window either shuts
it down gracefully or exits like a reclaimed host. Every member's watch
loop drains a peer that announced and relays the notice into its own
pub/sub, where train controllers listen. Chaos also fires at an agent's
task execution (`kill_node` there takes the whole agent down).

Head restart: a member whose GCS client sees the head come back
(`_on_head_state` "reconnected") declares no peer dead by absence for
`node_stale_s`, re-adopts the head's epoch (a bump is how it learns of a
restart), registers again and flushes its federation at once
(`_after_head_reconnect`). After a bump the window widens to the restored
head's reconcile grace (`head_reconcile_grace_s`, 3 x `node_stale_s` by
default): a restarted head's view starts empty, and a survivor may
re-report seconds after this member. The restored head's reconciliation lives in `runtime.py`.

Federation: every `node_stats_period_s` the heartbeat piggybacks the
node's stats snapshot (`core/stats.py`) and its buffered-federation depth
into its node-table entry, and ships its new flight-recorder events,
request marks and step marks into the GCS tables `_events`, `_requests`
and `_steps` (one key per node, a single writer; a cursor that walks
oldest-first and advances only after a successful put; a flush after a
reconnect drops by seq what already landed; each table capped per node).
The node server answers `node_logs`, `node_events`, `node_spans`,
`metrics_snapshot`, `node_stats` and `profile_capture`, which
`fanout_nodes` calls on every live agent. A node running a profile
capture stays live in the view for the capture's hold (`quiet`, beyond
JAX): torch.profiler's stop holds the whole process while it processes
the trace, so its heartbeats stop meanwhile.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import queue
import socket
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .exceptions import ActorDiedError
from .gcs import EVENT_NS, PREEMPT_CHANNEL, REQLOG_NS, STEPLOG_NS
from .gcs_service import PG_NS, GcsClient
from .ids import ActorID, NodeID, ObjectID
from .object_transfer import ObjectTransferServer, fetch_object
from .resources import ResourceSet
from .rpc import RpcClient, RpcError, dumps
from .scheduler import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    RemoteNode,
    TaskSpec,
    _resolve,
)
from .worker_pool import WorkerCrashedError

logger = logging.getLogger(__name__)

PROTO_NS = "_protocol"   # GCS KV: "version" -> the head's membership protocol
NODE_NS = "_nodes"       # GCS KV: node_id hex -> node info dict
OBJDIR_NS = "_objdir"    # GCS KV: object id hex -> transfer address
ACTOR_NS = "_cluster_actors"  # GCS KV: "<namespace>/<name>" -> {node_hex, actor_hex}

# The membership protocol a port head advertises: not JAX's integer (its
# rpc.PROTOCOL_VERSION), so the two packages never join one cluster.
PORT_PROTOCOL = "torch-1"
JAX_PROTOCOL = 1


def _loaded_steplog():
    """The training-forensics recorder IFF the train package is already
    loaded in this process: a process that never imported it has no step
    marks to federate, and importing it here would stall the stats thread
    the head's heartbeat rides on."""
    import sys

    return sys.modules.get("ray_tpu_torch.train.steplog")


class _RemoteActorCall:
    """One in-flight method call on a remote actor."""

    __slots__ = ("task_hex", "method", "args", "kwargs", "return_ids",
                 "sent_at", "strikes", "trace_ctx")

    def __init__(self, task_hex, method, args, kwargs, return_ids):
        self.task_hex = task_hex
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.return_ids = return_ids
        self.sent_at = 0.0     # set when the sender ships it
        self.strikes = 0       # consecutive "unknown" poll replies
        self.trace_ctx = None  # caller's actor.call span (wire context)


class _PendingTask:
    """Owner-side record of a task dispatched to a node agent."""

    __slots__ = ("spec", "node", "pool", "sent_at", "polled_at", "strikes")

    def __init__(self, spec, node, pool):
        self.spec = spec
        self.node = node
        self.pool = pool
        # 0 until the agent ACCEPTED the dispatch: the poll loop must not
        # probe (and strike out) a task whose execute_task RPC is still in
        # flight — the agent genuinely has no record of it yet
        self.sent_at = 0.0
        self.polled_at = 0.0
        self.strikes = 0  # consecutive "unknown" poll replies


class _ParkedResult:
    """Agent-side record of a completion the owner could not be told
    about. The sealed values stay in this node's store; the owner's poll
    loop re-pulls the completion through poll_task_done."""

    __slots__ = ("statuses", "error_blob", "oids", "expires_at", "delivered")

    def __init__(self, statuses, error_blob, oids, ttl):
        self.statuses = statuses
        self.error_blob = error_blob
        self.oids = oids  # locally sealed return ids (freed on TTL expiry)
        self.expires_at = time.monotonic() + ttl
        # once a poll reply carried this record the owner may hold refs
        # into the values: the TTL sweep then drops only the RECORD
        self.delivered = False


def _error_blob(exc: BaseException, tb: str) -> bytes:
    try:
        return pickle.dumps((exc, tb))
    except Exception:
        return pickle.dumps((RuntimeError(f"{type(exc).__name__}: {exc!r}"), tb))


class RemoteActorProxy:
    """Owner-side stand-in for an actor hosted by a node agent. Method
    calls enqueue here and one sender thread ships them in SUBMISSION
    ORDER — the agent's mailbox then serializes execution, so calls across
    processes keep the local actor ordering contract.

    Lifecycle: PENDING (creation in flight; calls buffer) → ALIVE (calls
    stream) → DEAD (calls fail with ActorDiedError). With max_restarts >
    0, a hosting-node death instead goes ALIVE → RESTARTING → ALIVE: the
    owner re-creates the actor on a surviving feasible node, in-flight
    calls fail (no replay), queued calls wait and then flow to the new
    incarnation, and the named-actor directory repoints."""

    def __init__(self, ctx: "ClusterContext", actor_id: ActorID, name: str):
        self.ctx = ctx
        self.actor_id = actor_id
        self.display_name = name
        self.state = "PENDING"
        self.death_reason = ""
        self.node: Optional[RemoteNode] = None
        self.resources: Dict[str, float] = {}
        # the pool the owner-side reservation was drawn from (the node's
        # resource view)
        self.pool = None
        # everything needed to re-create the actor elsewhere (absent on
        # lookup-built proxies, which therefore never restart)
        self.creation: Optional[Dict[str, Any]] = None
        self.restarts_used = 0
        # set when the owner registered a name for this actor; cleared
        # (and unregistered) on death so names never squat
        self.registered_name: Optional[str] = None
        self.registered_namespace: str = "default"
        self._queue: "queue.Queue[Optional[_RemoteActorCall]]" = queue.Queue()
        self._inflight: Dict[str, _RemoteActorCall] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._created = threading.Event()
        self._sender = threading.Thread(
            target=self._send_loop, daemon=True,
            name=f"ray_tpu_torch-ractor-{actor_id.hex()[:8]}",
        )
        self._sender.start()

    # ----------------------------------------------------------- submission

    def submit(self, call: _RemoteActorCall) -> None:
        with self._lock:
            if self.state == "DEAD":
                self._fail_call(call, self.death_reason)
                return
        self._queue.put(call)
        # re-check AFTER the enqueue: die()/stop() may have raced us and
        # the sender may be gone with our call queued — drain it here
        with self._lock:
            dead = self.state == "DEAD"
        if dead:
            self._drain_queue_failed()

    def _drain_queue_failed(self) -> None:
        saw_sentinel = False
        while True:
            try:
                c = self._queue.get_nowait()
            except queue.Empty:
                break
            if c is None:
                saw_sentinel = True  # stop()'s shutdown marker: not ours
            else:
                self._fail_call(c, self.death_reason or "actor is dead")
        if saw_sentinel:
            self._queue.put(None)  # re-post so the sender still sees it

    def _send_loop(self) -> None:
        self._created.wait()
        while True:
            call = self._queue.get()
            if call is None:
                self._drain_queue_failed()
                return
            # a restart is in flight: queued calls WAIT for the new
            # incarnation instead of failing
            while True:
                with self._lock:
                    state = self.state
                if state != "RESTARTING" or self.ctx._stop.is_set():
                    break
                time.sleep(0.02)
            with self._lock:
                if self.state != "ALIVE":
                    self._fail_call(call, self.death_reason or "actor is dead")
                    continue
                node = self.node
                self._inflight[call.task_hex] = call
            with self.ctx._lock:
                self.ctx._actor_calls[call.task_hex] = self
            try:
                # small args resolve HERE (owner side, in submission
                # order); big / remote ones ship as refs like task dispatch
                blob = dumps({
                    "actor_hex": self.actor_id.hex(),
                    "task_hex": call.task_hex,
                    "method": call.method,
                    "args": self.ctx._ship_args(call.args),
                    "kwargs": self.ctx._ship_args(call.kwargs),
                    "return_oids": [oid.hex() for oid in call.return_ids],
                    "reply_addr": self.ctx.address,
                    "trace_ctx": call.trace_ctx,
                })
                reply = node.client.call("call_actor", blob)
                if reply != "accepted":
                    raise RpcError(f"agent rejected actor call: {reply!r}")
                call.sent_at = time.monotonic()  # the poll loop may probe it now
            except (RpcError, OSError) as exc:
                self._forget(call)
                self._on_transport_failure(call, node, exc)
            except BaseException as exc:  # noqa: BLE001 - serialization errors: this call only
                self._forget(call)
                if isinstance(exc, KeyError) and "no hosted actor" in str(exc):
                    # the agent answered but no longer hosts the actor
                    self._recover_or_die(call, exc)
                    continue
                for oid in call.return_ids:
                    self.ctx.runtime.object_store.seal_error(oid, exc)

    def _forget(self, call: _RemoteActorCall) -> None:
        with self._lock:
            self._inflight.pop(call.task_hex, None)
        with self.ctx._lock:
            self.ctx._actor_calls.pop(call.task_hex, None)

    def _on_transport_failure(self, call, node, exc) -> None:
        if not self._restart_budget():
            # the budget may be spent BECAUSE a restart (racing this stale
            # RPC) already ran: a restart in progress, or a proxy repointed
            # elsewhere, must not die of the old node's failure
            with self._lock:
                state, current = self.state, self.node
            if state == "RESTARTING" or (current is not None and current is not node):
                self._fail_call(call, f"actor call transport failed: {exc!r}")
                return
            self.die(f"actor call transport failed: {exc!r}")
            self._fail_call(call, self.death_reason)
            return
        if node is not None and not node.alive:
            # the node's death was already declared: recover NOW
            self._recover_or_die(call, exc)
            return
        # node still looks alive: does the agent still host the actor? A
        # healthy agent that lost it would otherwise fail call after call
        try:
            probe = node.client.call("actor_state", self.actor_id.hex())
        except Exception:
            probe = None  # unreachable: heartbeats will decide
        if probe == "DEAD":
            self._recover_or_die(call, exc)
        else:
            self._fail_call(call, f"actor call transport failed: {exc!r}")

    def _fail_call(self, call: _RemoteActorCall, reason: str) -> None:
        err = ActorDiedError(self.actor_id, reason or "remote actor died")
        for oid in call.return_ids:
            self.ctx.runtime.object_store.seal_error(oid, err)

    # ------------------------------------------------------------ lifecycle

    def mark_alive(self, node: RemoteNode) -> None:
        with self._lock:
            # only a PENDING proxy takes the creation worker's node: a
            # restart that won the race already repointed elsewhere
            if self.state == "PENDING":
                self.node = node
                self.state = "ALIVE"
        self._created.set()

    def _restart_budget(self) -> bool:
        c = self.creation
        return c is not None and self.restarts_used < c["max_restarts"]

    def _recover_or_die(self, call: "_RemoteActorCall", exc) -> None:
        """The hosting side can no longer serve this actor: restart when
        budgeted, else die. The triggering call fails either way."""
        why = f"actor lost: {exc!r}"
        if self._restart_budget() and self.begin_restart(why):
            self.restarts_used += 1
            self.ctx._spawn(self.ctx._restart_proxy, (self, why),
                            f"ray_tpu_torch-ractor-restart-{self.actor_id.hex()[:8]}")
            self._fail_call(call, why)
        elif self.state == "RESTARTING":
            self._fail_call(call, why)  # another path owns the restart
        else:
            self.die(why)
            self._fail_call(call, self.death_reason)

    def begin_restart(self, reason: str) -> bool:
        """ALIVE/PENDING → RESTARTING: fail in-flight calls (no replay),
        release the old reservation, hold queued calls. False if the
        actor is dead or a restart is already in flight."""
        with self._lock:
            if self.state in ("DEAD", "RESTARTING"):
                return False
            self.state = "RESTARTING"
            inflight = list(self._inflight.values())
            self._inflight.clear()
            pool, resources = self.pool, self.resources
            self.pool = None
            self.resources = {}
        with self.ctx._lock:
            for call in inflight:
                self.ctx._actor_calls.pop(call.task_hex, None)
        for call in inflight:
            self._fail_call(call, reason)
        if pool is not None and resources:
            pool.release(resources)
        return True

    def complete_restart(self, node: RemoteNode, pool, resources) -> None:
        with self._lock:
            if self.state != "RESTARTING":
                # killed while restarting: the acquisition is ours to undo
                if resources:
                    pool.release(resources)
                return
            self.node = node
            self.pool = pool
            self.resources = dict(resources)
            self.state = "ALIVE"
        # a restart may beat the original creation worker: the sender
        # must not stay parked on _created
        self._created.set()

    def die(self, reason: str) -> None:
        """Fail every queued and in-flight call and all future ones."""
        with self._lock:
            if self.state == "DEAD":
                return
            self.state = "DEAD"
            self.death_reason = reason
            inflight = list(self._inflight.values())
            self._inflight.clear()
            pool, resources = self.pool, self.resources
            self.resources = {}
            self.creation = None  # drop the pinned creation payload
        self._created.set()  # unblock the sender so it can drain / fail
        with self.ctx._lock:
            for call in inflight:
                self.ctx._actor_calls.pop(call.task_hex, None)
        for call in inflight:
            self._fail_call(call, reason)
        if pool is not None and resources:
            pool.release(resources)
        # a dead actor must not squat its name
        if self.registered_name:
            self.ctx.runtime.gcs.unregister_named_actor(
                self.registered_name, self.registered_namespace)
            try:
                self.ctx.gcs.kv_delete(
                    f"{self.registered_namespace}/{self.registered_name}",
                    namespace=ACTOR_NS)
            except (RpcError, OSError):
                pass
            self.registered_name = None

    def take_inflight(self, task_hex: str) -> Optional[_RemoteActorCall]:
        with self._lock:
            return self._inflight.pop(task_hex, None)

    def stop(self) -> None:
        self._created.set()
        self._queue.put(None)

    def join(self, timeout: Optional[float] = None) -> None:
        self._sender.join(timeout)


class ClusterContext:
    """Everything one process needs to be a member of a cluster: the node
    server, the GCS client, the heartbeat / watch loop, the remote
    dispatcher and the agent-side executor."""

    def __init__(self, runtime, gcs_address: str, *, token: Optional[str] = None,
                 is_head: bool = False, bind_host: Optional[str] = None):
        from .config import cfg

        self.runtime = runtime
        self.token = token or None
        self.is_head = is_head
        self.gcs_address = gcs_address
        bind_host = bind_host or cfg.cluster_bind_host
        if bind_host not in ("127.0.0.1", "localhost") and not self.token:
            raise ValueError(
                "binding cluster services off-localhost requires a cluster token "
                "(RPC peers can execute code; see rpc.py auth)"
            )
        store = runtime.object_store
        # one server, one port: the transfer plane + the agent control plane
        self.server = ObjectTransferServer(store, host=bind_host, token=self.token)
        for name, fn in {
            "execute_task": self._execute_task,
            "task_done": self._task_done,
            "free_object": self._free_object,
            "borrow_object": self._borrow_object,
            "unborrow_object": self._unborrow_object,
            "node_info": self._node_info,
            "shutdown_node": self._shutdown_node,
            "create_actor": self._agent_create_actor,
            "call_actor": self._agent_call_actor,
            "kill_actor": self._agent_kill_actor,
            "actor_state": self._agent_actor_state,
            "actor_task_done": self._actor_task_done,
            "poll_task_done": self._poll_task_done,
            "stream_item": self._stream_item,
            "reserve_bundle": self._reserve_bundle,
            "release_bundle": self._release_bundle,
            "node_logs": self._node_logs,
            "node_events": self._node_events,
            "node_spans": self._node_spans,
            "metrics_snapshot": self._metrics_snapshot,
            "node_stats": self._node_stats,
            "profile_capture": self._profile_capture,
        }.items():
            self.server.register(name, fn)
        self.address = self.server.address

        self.gcs = GcsClient(gcs_address, token=self.token)
        local = runtime.scheduler.head_node()
        self.node_id: NodeID = local.node_id
        self._local_node = local
        self._lock = threading.Lock()
        # dispatch bookkeeping: task hex -> _PendingTask
        self._pending: Dict[str, _PendingTask] = {}  # guarded-by: _lock
        # agent-side admission: the ledger IS the local node's ResourceSet,
        # shared with the local scheduler
        self._admit_queue_cap = cfg.agent_admission_queue or max(8, 4 * (os.cpu_count() or 1))
        self._admit_queue: deque = deque()  # guarded-by: _admit_lock
        self._admit_lock = threading.Lock()
        # task hexes this agent accepted (queued or executing): the owner's
        # poll tells running / parked / unknown apart with it
        self._agent_running: set = set()  # guarded-by: _lock
        self._parked: Dict[str, _ParkedResult] = {}  # guarded-by: _lock
        self.agent_stats = {"admitted": 0, "queued": 0, "bounced": 0, "parked": 0}
        # ANY release of this node's ledger may unblock queued admissions
        self._local_node.resources.on_release = self._drain_admission
        # placement-group bundles other members reserved on this node:
        # (pg hex, bundle index) -> the reserved pool, drawn from this
        # node's ledger; tasks and actors dispatched into a bundle lease
        # from its pool. _bundle_owner names the reserving node.
        self._hosted_bundles: Dict[Tuple[str, int], Any] = {}  # guarded-by: _lock
        self._bundle_owner: Dict[Tuple[str, int], str] = {}  # guarded-by: _lock
        # this node's announced preemption (a one-shot latch), the timer
        # of its window, and the pub/sub cursor of peers' notices
        self._preempting = False  # guarded-by: _lock
        self._preempt_timer: Optional[threading.Timer] = None
        self._preempt_since = 0.0
        # this node's table entry, kept here so begin_preemption updates
        # it without a read of the GCS
        self._info: Dict[str, Any] = {}  # guarded-by: _lock
        # the stats piggyback's gate, and the federation cursors: the last
        # local event / reqlog mark / steplog mark seq shipped into the
        # GCS tables (advanced only after a successful put)
        self._last_stats_ts = 0.0  # guarded-by: _lock
        self._events_cursor = 0
        self._reqlog_cursor = 0
        self._steplog_cursor = 0
        # remote actors this process OWNS (proxies), and the in-flight
        # actor calls awaiting an actor_task_done reply
        self.remote_actors: Dict[ActorID, RemoteActorProxy] = {}  # guarded-by: _lock
        self._actor_calls: Dict[str, RemoteActorProxy] = {}  # guarded-by: _lock
        # actors THIS node hosts for remote owners: actor hex -> handle
        self._hosted_actors: Dict[str, Any] = {}  # guarded-by: _lock
        self._remote_nodes: Dict[str, RemoteNode] = {}  # guarded-by: _lock
        self._reply_clients: Dict[str, RpcClient] = {}  # guarded-by: _lock
        self._free_queue: "queue.Queue[Tuple[str, str, str]]" = queue.Queue()
        self._borrow_queue: "queue.Queue[tuple]" = queue.Queue()
        # (oid_hex, owner_addr) -> "queued" | "sent": the ordering latch
        # between a borrow registration and its eventual unborrow
        self._borrow_state: Dict[Tuple[str, str], str] = {}  # guarded-by: _lock
        self._stop = threading.Event()
        self.shutdown_requested = threading.Event()
        # short-lived threads (actor creation / restart): joined at stop
        self._workers: set = set()  # guarded-by: _lock
        # after the head reconnects, suppress death-by-absence until this
        # monotonic deadline: peers need stale_s to reappear in its view
        self._view_trust_after = 0.0
        # while a profile capture holds this process, each report asks the
        # head to keep the node live until this monotonic deadline
        self._quiet_until = 0.0
        self.gcs.on_head_state(self._on_head_state)

        store.set_cluster_hooks(
            fetch_remote=self._fetch_remote,
            locate=self._locate,
            free_remote=self._enqueue_free,
            unborrow=self._enqueue_unborrow,
        )
        runtime.scheduler.remote_dispatcher = self._dispatch
        runtime.scheduler.remote_bundle_reserver = self._reserve_remote_bundles
        runtime.scheduler.remote_bundle_releaser = self._release_remote_bundles
        runtime.scheduler.pg_state_sink = self._record_pg_state
        try:
            self._register()
        except BaseException:
            self._local_node.resources.on_release = None
            self._unhook_scheduler()
            store.set_cluster_hooks(None, None)
            self.gcs.close()
            self.server.stop()
            raise
        self._loops = [
            threading.Thread(target=target, daemon=True, name=f"ray_tpu_torch-cluster-{name}")
            for name, target in (("watch", self._watch_loop), ("free", self._free_loop),
                                 ("borrow", self._borrow_loop), ("poll", self._poll_loop))
        ]
        for th in self._loops:
            th.start()

    def _spawn(self, target, args, name: str) -> None:
        """A short-lived worker thread, tracked so stop() joins it."""

        def run():
            try:
                target(*args)
            finally:
                with self._lock:
                    self._workers.discard(threading.current_thread())

        th = threading.Thread(target=run, daemon=True, name=name)
        with self._lock:
            self._workers.add(th)
        th.start()

    # ------------------------------------------------------------ membership

    def _register(self) -> None:
        """Heartbeat FIRST, then the table entry: watchers discover nodes
        from the table but declare death from heartbeat staleness, so the
        heartbeat must never lag the registration."""
        if self.is_head:
            self.gcs.kv_put("version", PORT_PROTOCOL, namespace=PROTO_NS)
        else:
            head_proto = self.gcs.kv_get("version", namespace=PROTO_NS)
            if head_proto == JAX_PROTOCOL:
                raise RuntimeError(
                    f"the cluster head at {self.gcs_address} is a ray_tpu (JAX) head "
                    f"(membership protocol {JAX_PROTOCOL!r}); this node is "
                    f"ray_tpu_torch (protocol {PORT_PROTOCOL!r}): a cluster runs one "
                    f"package — start this node with `python -m ray_tpu start`, or "
                    f"the head with `python -m ray_tpu_torch start --head`"
                )
            if head_proto is not None and head_proto != PORT_PROTOCOL:
                raise RuntimeError(
                    f"cluster head speaks membership protocol {head_proto!r}, this "
                    f"ray_tpu_torch node speaks {PORT_PROTOCOL!r}; run one version "
                    f"of the package on every node"
                )
        # epoch fencing: every write from here on carries the head's epoch
        self.gcs.adopt_epoch()
        self._heartbeat()
        info = {
            "node_id": self.node_id.hex(),
            "address": self.address,
            "resources": dict(self._local_node.resources.total),
            "labels": dict(self._local_node.labels),
            "is_head": self.is_head,
            "protocol": PORT_PROTOCOL,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "joined_at": time.time(),
            "epoch": self.gcs.epoch,
        }
        with self._lock:
            self._info = info
        self.gcs.kv_put(self.node_id.hex(), info, namespace=NODE_NS)
        logger.info("node %s joined cluster at %s (gcs %s)",
                    self.node_id.hex()[:12], self.address, self.gcs_address)

    def _on_head_state(self, state: str, outage_s: float) -> None:
        """GcsClient outage-transition hook (one call per transition, from
        whichever thread hit it). On reconnect the head may be a RESTARTED
        process with restored tables and a bumped epoch: push the liveness
        trust window out, then re-adopt and re-announce on a thread of its
        own (this fires inside an RPC call path and must not block it)."""
        if state != "reconnected" or self._stop.is_set():
            return
        from .config import cfg

        self._view_trust_after = max(self._view_trust_after,
                                     time.monotonic() + float(cfg.node_stale_s))
        self._spawn(self._after_head_reconnect, (outage_s,), "ray_tpu_torch-head-reconnect")

    def _after_head_reconnect(self, outage_s: float) -> None:
        """Re-announce to a possibly restarted head: re-adopt its epoch,
        register again (node entry + heartbeat), and open the stats gate,
        so the federation cursors (held for the whole outage: they advance
        only after a successful put) flush at once."""
        try:
            old_epoch = self.gcs.epoch
            new_epoch = self.gcs.adopt_epoch()
            if old_epoch is not None and new_epoch != old_epoch:
                # a restarted head: trust no absence for its reconcile grace,
                # not JAX's node_stale_s: its view starts empty, a survivor
                # still in its client's reconnect backoff may re-report
                # seconds after this member, and the head itself waits that
                # long before purging a node that never returned
                from .config import head_reconcile_grace

                self._view_trust_after = max(self._view_trust_after,
                                             time.monotonic() + head_reconcile_grace())
            with self._lock:
                self._last_stats_ts = 0.0  # flush the buffered federation now
            self._register()
            if old_epoch is not None and new_epoch != old_epoch:
                from ..util.events import emit

                emit("INFO", "cluster",
                     f"node {self.node_id.hex()[:12]} re-registered with restarted head "
                     f"(epoch {old_epoch} -> {new_epoch}, outage {outage_s:.2f}s)",
                     kind="node.discovered", node=self.node_id.hex(),
                     epoch=new_epoch, outage_s=round(outage_s, 3))
        except (RpcError, OSError) as exc:
            # the head dropped again mid-recovery: the next reconnect (or
            # the watch loop's heartbeat) retries
            logger.warning("re-registration after head reconnect failed: %r", exc)

    def _heartbeat(self) -> None:
        self.gcs.report_resources(
            self.node_id.hex(), dict(self._local_node.resources.available()),
            max(0.0, self._quiet_until - time.monotonic()))
        self._report_stats()

    @contextlib.contextmanager
    def quiet(self, seconds: float) -> Iterator[None]:
        """Keep this node live in the cluster view for `seconds` without
        heartbeats, for the block's length (beyond JAX): a profile
        capture's stop holds the whole process while it processes the
        trace (`profiling.CAPTURE_HOLD_S`), and peers must not declare it
        dead meanwhile. The first heartbeat after the block ends the
        window."""
        self._quiet_until = time.monotonic() + seconds
        try:
            try:
                self.gcs.report_resources(
                    self.node_id.hex(), dict(self._local_node.resources.available()), seconds)
            except (RpcError, OSError) as exc:
                logger.warning("could not announce %.0f s of quiet to the head: %r", seconds, exc)
            yield
        finally:
            self._quiet_until = 0.0

    def _report_stats(self) -> None:
        """Telemetry piggyback on the heartbeat: every node_stats_period_s,
        publish this node's stats snapshot (and its federation depth) into
        its GCS node-table entry, then ship the federation batches. Rides
        the heartbeat's failure envelope: a GCS blip skips a period."""
        from .config import cfg

        period = cfg.node_stats_period_s
        if period <= 0:
            return
        collector = getattr(self.runtime, "node_stats", None)
        if collector is None:
            return
        now = time.monotonic()
        # check-and-set at once: the reconnect thread calls this path too,
        # and two threads through the gate would ship one batch twice
        with self._lock:
            if now - self._last_stats_ts < period or not self._info:
                return
            self._last_stats_ts = now
        snap = collector.snapshot()
        lag = self._federation_lag()
        with self._lock:
            self._info["stats"] = snap
            self._info["federation_lag"] = lag
            info = dict(self._info)
        self.gcs.kv_put(self.node_id.hex(), info, namespace=NODE_NS)
        self._federate_events()
        self._federate_requests()
        self._federate_steps()

    def _federation_lag(self) -> Dict[str, int]:
        """How many local events / reqlog marks / steplog marks have not
        shipped to the head yet: grows for the length of a head outage
        and drains to 0 after the reconnect."""
        from ..serve import reqlog
        from ..util.events import events

        lag = {"events": max(0, events().stats()["seq"] - self._events_cursor)}
        if reqlog.enabled():
            lag["requests"] = max(0, reqlog.log().stats()["seq"] - self._reqlog_cursor)
        steplog = _loaded_steplog()
        if steplog is not None and steplog.enabled():
            lag["steps"] = max(0, steplog.log().stats()["seq"] - self._steplog_cursor)
        return lag

    def _federate(self, namespace: str, batch: List[Dict[str, Any]], cap: int) -> int:
        """Append `batch` (oldest first) to this node's key of a federated
        table and return the seq the cursor moves to. The key has one
        writer (this node), so the read-modify-write is safe; marks the
        table already holds (a put that landed but whose reply was lost to
        an outage) are dropped by seq; the table keeps the newest `cap`."""
        my_hex = self.node_id.hex()
        tail = self.gcs.kv_get(my_hex, namespace=namespace) or []
        shipped = {m.get("seq") for m in tail}
        fresh = [m for m in batch if m["seq"] not in shipped]
        if fresh:
            tail.extend(m if m.get("node") else dict(m, node=my_hex) for m in fresh)
            if len(tail) > cap:
                del tail[: len(tail) - cap]
            self.gcs.kv_put(my_hex, tail, namespace=namespace)
        return batch[-1]["seq"]

    def _federate_events(self) -> None:
        """Ship this node's new flight-recorder events into `_events`."""
        from ..util.events import events
        from .config import cfg

        batch = events().since(self._events_cursor, max_n=cfg.events_federate_batch)
        if batch:
            self._events_cursor = self._federate(EVENT_NS, batch, cfg.events_table_cap)

    def _federate_requests(self) -> None:
        """Ship this node's new request marks into `_requests`, so the head
        answers `state.request_timeline(id)` for a request whose router hop
        and engine hop ran on different nodes."""
        from ..serve import reqlog
        from .config import cfg

        if not reqlog.enabled():
            return
        batch = reqlog.log().since(self._reqlog_cursor, max_n=cfg.reqlog_federate_batch)
        if batch:
            self._reqlog_cursor = self._federate(REQLOG_NS, batch, cfg.reqlog_table_cap)

    def _federate_steps(self) -> None:
        """Ship this node's new step marks into `_steps`, so the head
        answers `state.step_timeline(run)` across every rank of a gang."""
        from .config import cfg

        steplog = _loaded_steplog()
        if steplog is None or not steplog.enabled():
            return
        batch = steplog.log().since(self._steplog_cursor, max_n=cfg.steplog_federate_batch)
        if batch:
            self._steplog_cursor = self._federate(STEPLOG_NS, batch, cfg.steplog_table_cap)

    def _watch_loop(self) -> None:
        from .config import cfg

        period = cfg.node_heartbeat_s
        while not self._stop.wait(period):
            try:
                self._heartbeat()
                self._refresh_nodes()
                self._poll_preemptions()
            except (RpcError, OSError) as exc:
                # GCS unreachable: keep trying — a transient blip must not
                # tear the node down
                logger.warning("cluster heartbeat failed: %r", exc)
            except Exception:
                logger.exception("cluster watch loop error")

    def _refresh_nodes(self) -> None:
        view = self.gcs.cluster_view()
        live = set(view["nodes"])
        my_hex = self.node_id.hex()
        for node_hex in live:  # joins and rejoins
            if node_hex == my_hex:
                continue
            with self._lock:
                known = self._remote_nodes.get(node_hex)
            if known is not None and known.alive:
                continue
            info = self.gcs.kv_get(node_hex, namespace=NODE_NS)
            if not info:
                continue
            # unknown, OR locally quarantined after a dispatch failure but
            # still heartbeating: (re)join with a fresh client
            node = RemoteNode(NodeID(node_hex), dict(info["resources"]), info["address"],
                              token=self.token, labels=info.get("labels") or {})
            node.pid = info.get("pid")  # the agent's process (the capacity plane's launches)
            with self._lock:
                if self._stop.is_set():
                    node.client.close()
                    return
                self._remote_nodes[node_hex] = node
            if known is not None:
                known.client.close()
            self.runtime.scheduler.add_node(node)
            if info.get("preempting"):
                # found after its announcement: never place anything there
                self.runtime.scheduler.mark_node_draining(
                    node_hex, info.get("preempt_reason", "preempting"),
                    info.get("preempt_deadline", 0.0))
            from ..util.events import emit

            what = "rediscovered" if known is not None else "discovered"
            emit("INFO", "cluster", f"node {node_hex[:12]} {what}",
                 kind="node.discovered", node=node_hex, address=info["address"])
            logger.info("%s cluster node %s at %s", what, node_hex[:12], info["address"])
        # deaths: a known node absent from the live view aged out of
        # heartbeats — suppressed inside the post-reconnect trust window
        if time.monotonic() < self._view_trust_after:
            return
        with self._lock:
            known_nodes = list(self._remote_nodes)
        for node_hex in known_nodes:
            if node_hex not in live:
                self._on_node_dead(node_hex, "missed heartbeats")

    def _on_node_dead(self, node_hex: str, reason: str) -> None:
        """Heartbeat-confirmed death: deregister cluster-wide and fail over
        every task in flight there. (A failed dispatch only quarantines a
        node locally until heartbeats decide.)"""
        with self._lock:
            node = self._remote_nodes.pop(node_hex, None)
        if node is None:
            return
        from ..util.events import emit

        emit("WARNING", "cluster", f"node {node_hex[:12]} died",
             kind="node.dead", node=node_hex, reason=reason)
        logger.warning("cluster node %s died (%s)", node_hex[:12], reason)
        try:
            self.gcs.kv_delete(node_hex, namespace=NODE_NS)
        except (RpcError, OSError):
            pass
        node.client.close()
        # claim the tasks in flight there (matched by node id, so tasks
        # dispatched before a rejoin are covered); a late task_done then
        # reads "stale"
        with self._lock:
            doomed = [(hex_, rec) for hex_, rec in self._pending.items()
                      if rec.node.node_id.hex() == node_hex]
            for hex_, _ in doomed:
                del self._pending[hex_]
        # placement groups with bundles there go RESCHEDULING here, BEFORE
        # the actor restarts below, so a bundle actor's restart finds its
        # group rescheduling and waits for the re-reservation
        self.runtime.scheduler.handle_node_death(
            node_hex, reason, [(rec.spec, rec.node, rec.pool) for _, rec in doomed])
        # remote actors hosted there: restart elsewhere when budgeted
        with self._lock:
            proxies = [p for p in self.remote_actors.values()
                       if p.node is not None and p.node.node_id.hex() == node_hex]
        for proxy in proxies:
            why = f"hosting node {node_hex[:12]} died: {reason}"
            if proxy._restart_budget():
                if proxy.begin_restart(why):
                    proxy.restarts_used += 1
                    self._spawn(self._restart_proxy, (proxy, why),
                                f"ray_tpu_torch-ractor-restart-{proxy.actor_id.hex()[:8]}")
            else:
                proxy.die(why)
        # its borrows will never be unregistered: a crashed agent must not
        # pin our values forever
        released = self.runtime.object_store.release_borrows_from(node.agent_addr)
        if released:
            logger.info("released %d borrows held by dead node %s", released, node_hex[:12])
        # and the bundles its owner reserved HERE go back to the ledger
        freed = self._release_bundles_owned_by(node_hex)
        if freed:
            logger.info("released %d PG bundles reserved by dead node %s", freed, node_hex[:12])

    # ------------------------------------------------------------ preemption

    def begin_preemption(self, reason: str, warning_s: Optional[float] = None,
                         fate: str = "shutdown") -> None:
        """THIS node received a notice of its death (SIGTERM, chaos
        preempt_node). Announce it through the GCS pub/sub and the node
        table, stop placing onto this node, and after the warning window
        either ask for a graceful shutdown (fate "shutdown", the SIGTERM
        handler) or exit like a reclaimed host (fate "exit", chaos). A
        second notice neither shortens nor doubles the drill."""
        from .config import cfg

        if warning_s is None:
            warning_s = cfg.preempt_warning_s
        with self._lock:
            if self._preempting:
                return
            self._preempting = True
        deadline = time.time() + warning_s
        msg = {"node_hex": self.node_id.hex(), "reason": reason,
               "warning_s": warning_s, "deadline": deadline}
        # announce FIRST: peers must stop placing here before we vanish
        try:
            self.gcs.publish(PREEMPT_CHANNEL, msg)
        except (RpcError, OSError):
            pass  # cut off from the GCS: drain locally anyway
        with self._lock:
            self._info.update({"preempting": True, "preempt_reason": reason,
                               "preempt_deadline": deadline})
            info = dict(self._info)
        try:
            self.gcs.kv_put(self.node_id.hex(), info, namespace=NODE_NS)
        except (RpcError, OSError):
            pass
        # this process's own view and its subscribers (train controllers)
        self.runtime.scheduler.mark_node_draining(self.node_id.hex(), reason, deadline)
        self.runtime.gcs.pubsub.publish(PREEMPT_CHANNEL, msg)
        from ..util.events import emit

        emit("WARNING", "cluster",
             f"node {self.node_id.hex()[:12]} preempting: {reason} "
             f"({warning_s:.1f}s warning, fate={fate})",
             kind="preempt.announced", node=self.node_id.hex(),
             deadline=deadline, warning_s=warning_s)
        logger.warning("preemption notice (%s): %s, warning %.1fs", fate, reason, warning_s)

        def expire() -> None:
            if fate == "exit":
                # the host is reclaimed: abrupt death, found by heartbeats
                os._exit(137)
            self.shutdown_requested.set()

        timer = threading.Timer(warning_s, expire)
        timer.daemon = True
        self._preempt_timer = timer
        timer.start()

    def _poll_preemptions(self) -> None:
        """The watch loop's arm for peers' notices: read them from the
        head's pub/sub history, drain those nodes in this process's view
        and relay each notice into the local pub/sub, so local
        subscribers (train controllers) hear cluster-wide preemptions. A
        node's own notice is never relayed back to it, and a node already
        drained is not relayed twice."""
        msgs = self.gcs.poll(PREEMPT_CHANNEL, self._preempt_since)
        for ts, msg in msgs:
            self._preempt_since = max(self._preempt_since, ts)
            node_hex = (msg or {}).get("node_hex")
            if not node_hex or node_hex == self.node_id.hex():
                continue  # our own: begin_preemption published it locally
            with self._lock:
                node = self._remote_nodes.get(node_hex)
            if node is not None and node.draining:
                continue
            if node is not None:
                self.runtime.scheduler.mark_node_draining(
                    node_hex, msg.get("reason", "preempted"), msg.get("deadline", 0.0))
            # relay even when the node table has not caught up yet; the
            # head's pub/sub IS the GCS's, where the notice already landed
            if not self.is_head:
                self.runtime.gcs.pubsub.publish(PREEMPT_CHANNEL, msg)

    def nodes(self) -> List[Dict[str, Any]]:
        """Cluster membership as recorded in the GCS node table."""
        out = []
        for key in self.gcs.kv_keys(namespace=NODE_NS):
            info = self.gcs.kv_get(key, namespace=NODE_NS)
            if info:
                out.append(info)
        return out

    # -------------------------------------------------- driver-side dispatch

    def _ship_args(self, container):
        """Prepare task / actor-call args for the wire. SMALL sealed values
        resolve here and ship inline; big or REMOTE-located values ship as
        the ObjectRef itself — the executing agent pulls them over the
        chunked plane (from the node that holds them, when known) and
        registers as a borrower meanwhile."""
        from .config import cfg
        from .object_store import ObjectState, Tier
        from .runtime import ObjectRef

        store = self.runtime.object_store

        def one(value):
            if not isinstance(value, ObjectRef):
                return value
            entry = store.entry(value.object_id)
            if entry is not None and entry.event.is_set() and entry.state == ObjectState.READY:
                if entry.tier == Tier.REMOTE:
                    return value  # lives elsewhere: peer-to-peer pull
                if entry.nbytes > cfg.remote_inline_max_bytes:
                    return value  # big: the agent pulls from us, chunked
            return store.get(value.object_id)

        if isinstance(container, tuple):
            return tuple(one(v) for v in container)
        return {k: one(v) for k, v in container.items()}

    def _dispatch(self, spec: TaskSpec, node: RemoteNode, pool) -> None:
        """Ship one task to a node agent (on a dispatch thread; the
        scheduler already acquired resources on its RemoteNode view).
        Never raises: every failure flows through finish_remote."""
        from ..util import tracing

        task_hex = spec.task_id.hex()
        with self._lock:
            self._pending[task_hex] = _PendingTask(spec, node, pool)
        now = time.time()
        lane = f"node:{node.node_id.hex()[:8]}"
        span_attrs = {"task": spec.name, "task_id": task_hex, "attempt": spec.attempt}
        tracing.tracer().record_span("task.queue", spec.submit_wall_ts, now,
                                     parent=spec.trace_ctx, lane=lane, attrs=span_attrs)
        dispatch_span = tracing.tracer().start_span(
            "task.dispatch", parent=spec.trace_ctx, lane=lane, attrs=span_attrs, start_ts=now)
        # a task aimed at a placement-group bundle leases from the agent's
        # reserved bundle pool, not its ledger
        bundle_key = None
        strategy = spec.scheduling_strategy
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            idx = next((b.index for b in pg.bundles if b.reserved is pool), None)
            if idx is not None:
                bundle_key = (pg.id.hex(), idx)
        try:
            blob = dumps({
                "task_hex": task_hex,
                "name": spec.name,
                "func": spec.func,
                "args": self._ship_args(spec.args),
                "kwargs": self._ship_args(spec.kwargs),
                "num_returns": spec.num_returns,
                "return_oids": [oid.hex() for oid in spec.return_ids],
                "resources": dict(spec.resources),
                "bundle": bundle_key,
                "runtime_env": spec.runtime_env,
                "executor": spec.executor,
                "streaming": spec.streaming,
                "stream_max_backlog": spec.stream_max_backlog,
                "reply_addr": self.address,
                "trace_ctx": dispatch_span.context,
            })
            with tracing.use_context(dispatch_span.context):
                reply = node.client.call("execute_task", blob)
            dispatch_span.end(accepted=(reply == "accepted"))
            if reply == "busy":
                # the agent's OWN ledger is full and its queue overflowed:
                # not a node failure — release and requeue after a beat
                with self._lock:
                    rec = self._pending.pop(task_hex, None)
                if rec is not None:
                    self.runtime.scheduler.requeue_remote(spec, node, pool)
                return
            if reply != "accepted":
                raise RpcError(f"agent rejected task: {reply!r}")
            with self._lock:
                rec = self._pending.get(task_hex)
                if rec is not None:
                    rec.sent_at = rec.polled_at = time.monotonic()
        except (RpcError, OSError) as exc:
            dispatch_span.end(status="ERROR", error=repr(exc))
            with self._lock:
                rec = self._pending.pop(task_hex, None)
            if rec is None:
                return  # task_done (or the node's death) raced us
            # quarantine LOCALLY only: heartbeats re-add a healthy agent, or
            # the staleness watcher declares a dead one
            logger.warning("dispatch to node %s failed; quarantining: %r",
                           node.node_id.hex()[:12], exc)
            self.runtime.scheduler.remove_node(node.node_id)
            self.runtime.scheduler.finish_remote(
                spec, node, pool,
                error=WorkerCrashedError(
                    f"dispatch of {spec.name} to node {node.node_id.hex()[:12]} failed: {exc!r}"),
                system_failure=True,
            )
        except BaseException as exc:  # noqa: BLE001 - serialization errors etc: user-level
            dispatch_span.end(status="ERROR", error=repr(exc))
            with self._lock:
                rec = self._pending.pop(task_hex, None)
            if rec is None:
                return
            self.runtime.scheduler.finish_remote(spec, node, pool, error=exc,
                                                 error_tb=traceback.format_exc())

    def _seal_statuses(self, return_ids, statuses) -> None:
        """("value", v): the value itself; ("remote", address, nbytes): a
        placeholder for a value kept at that node."""
        store = self.runtime.object_store
        for oid, status in zip(return_ids, statuses or ()):
            if status[0] == "value":
                store.create(oid)
                store.seal(oid, status[1])
            elif status[0] == "remote":
                store.seal_remote(oid, status[1], nbytes=status[2] if len(status) > 2 else 0)

    def _task_done(self, task_hex: str, statuses: Optional[List[Tuple[str, Any]]],
                   error_blob: Optional[bytes]) -> str:
        """Agent callback: the task finished there. The reservation on the
        node's view is released before the returns seal (finish_remote's
        `before_complete`)."""
        with self._lock:
            rec = self._pending.pop(task_hex, None)
        if rec is None:
            return "stale"  # the node was declared dead first; resubmitted
        spec, node, pool = rec.spec, rec.node, rec.pool
        if error_blob is not None:
            try:
                error, tb = pickle.loads(error_blob)
            except Exception:
                error, tb = RuntimeError("undecodable remote error"), ""
            self.runtime.scheduler.finish_remote(spec, node, pool, error=error, error_tb=tb)
            return "ok"
        def seal() -> None:
            self._seal_statuses(spec.return_ids, statuses)
            if spec.streaming:
                stream = spec.live_stream()
                if stream is not None:
                    stream._finish()  # end of stream for the consumer

        self.runtime.scheduler.finish_remote(spec, node, pool, before_complete=seal)
        return "ok"

    def _stream_item(self, task_hex: str, idx: int, oid_hex: str, status) -> str:
        """One yield of a streaming generator running on an agent: a small
        value inside `status`, a big one as a remote placeholder. The REPLY
        is the backpressure: "backlogged" makes the producer re-send,
        "stale" stops it."""
        with self._lock:
            rec = self._pending.get(task_hex)
        if rec is None:
            return "stale"
        spec = rec.spec
        oid = ObjectID(oid_hex)
        store = self.runtime.object_store
        store.create(oid, owner_task=spec)  # lineage: reconstructable
        if not store.is_ready(oid):
            self._seal_statuses([oid], [status])  # a re-sent item seals once
        if oid not in spec.return_ids:
            spec.return_ids.append(oid)
        stream = spec.live_stream()
        if stream is None:
            # the consumer dropped the generator: abandonment, not an agent
            # failure — close the task out cleanly
            self._finish_stream_task(task_hex)
            return "stale"
        if idx >= stream._appended:
            stream._append_oid(oid)
        if spec.stream_max_backlog:
            try:
                # a SHORT wait; a still-full backlog answers "backlogged"
                # and the producer re-sends the (idempotent) item
                stream._wait_backlog(spec.stream_max_backlog, timeout=30)
            except RuntimeError:
                self._finish_stream_task(task_hex)
                return "stale"  # consumer abandoned mid-wait
            except TimeoutError:
                return "backlogged"
        return "ok"

    def _finish_stream_task(self, task_hex: str) -> None:
        with self._lock:
            rec = self._pending.pop(task_hex, None)
        if rec is None:
            return
        stream = rec.spec.live_stream()
        if stream is not None:
            stream._finish()
        self.runtime.scheduler.finish_remote(rec.spec, rec.node, rec.pool)

    # --------------------------------------------- owner-side result recovery

    def _poll_loop(self) -> None:
        """Owner half of the delivery recovery: a dispatched task or actor
        call without a completion for pending_task_poll_s gets its agent
        asked directly ("parked" claims it; "unknown" twice fails over).
        Also runs the agent-side parked-result TTL sweep."""
        while not self._stop.wait(1.0):
            try:
                self._sweep_parked()
                self._poll_pending_tasks()
                self._poll_pending_actor_calls()
            except Exception:
                logger.exception("cluster poll loop error")

    def _poll_pending_tasks(self) -> None:
        from .config import cfg

        now = time.monotonic()
        with self._lock:
            due = [(hex_, rec) for hex_, rec in self._pending.items()
                   if rec.sent_at and now - rec.polled_at >= cfg.pending_task_poll_s]
        for task_hex, rec in due:
            rec.polled_at = time.monotonic()
            try:
                kind, statuses, error_blob = rec.node.client.call("poll_task_done", task_hex)
            except (RpcError, OSError):
                continue  # heartbeat staleness decides node death, not us
            if kind == "running":
                rec.strikes = 0
            elif kind == "parked":
                logger.info("reclaimed parked completion of task %s", task_hex[:12])
                self._task_done(task_hex, statuses, error_blob)
            else:  # unknown — maybe a completion in flight; two strikes
                rec.strikes += 1
                if rec.strikes < 2:
                    continue
                with self._lock:
                    still = self._pending.pop(task_hex, None)
                if still is None:
                    continue
                self.runtime.scheduler.finish_remote(
                    still.spec, still.node, still.pool,
                    error=WorkerCrashedError(
                        f"node {still.node.node_id.hex()[:12]} has no record of dispatched "
                        f"task {still.spec.name} (agent restarted?)"),
                    system_failure=True,
                )

    def _poll_pending_actor_calls(self) -> None:
        from .config import cfg
        from .exceptions import ActorUnavailableError

        now = time.monotonic()
        with self._lock:
            snapshot = list(self._actor_calls.items())
        for task_hex, proxy in snapshot:
            with proxy._lock:
                call = proxy._inflight.get(task_hex)
                node = proxy.node
            if call is None or node is None or not call.sent_at:
                continue
            if now - call.sent_at < cfg.pending_task_poll_s:
                continue
            call.sent_at = time.monotonic()  # next poll in a full period
            try:
                kind, statuses, error_blob = node.client.call("poll_task_done", task_hex)
            except (RpcError, OSError):
                continue
            if kind == "running":
                call.strikes = 0
            elif kind == "parked":
                logger.info("reclaimed parked actor-call completion %s", task_hex[:12])
                self._actor_task_done(task_hex, statuses, error_blob)
            else:
                call.strikes += 1
                if call.strikes < 2:
                    continue
                with self._lock:
                    known = self._actor_calls.pop(task_hex, None)
                if known is None:
                    continue
                gone = proxy.take_inflight(task_hex)
                if gone is None:
                    continue
                err = ActorUnavailableError(
                    f"the node hosting actor {proxy.actor_id} has no record of in-flight "
                    f"call {call.method!r}; its result is lost")
                for oid in gone.return_ids:
                    self.runtime.object_store.seal_error(oid, err)

    # ------------------------------------------ placement-group bundles

    def _reserve_remote_bundles(self, pg_hex: str, bundles) -> Optional[str]:
        """Phase 2 of the reservation, owner side: prepare each remote
        bundle at its agent, in order; on a refusal release the ones
        already granted (and the refused one: a grant that timed out may
        have landed after all) and report, so the scheduler replans."""
        prepared = []
        for bundle in bundles:
            try:
                reply = bundle.node.client.call("reserve_bundle", pg_hex, bundle.index,
                                                dict(bundle.resources), self.node_id.hex())
            except (RpcError, OSError) as exc:
                reply = f"unreachable: {exc!r}"
            if reply != "ok":
                self._release_remote_bundles(pg_hex, prepared + [bundle])
                return (f"agent {bundle.node.node_id.hex()[:12]} refused bundle "
                        f"{bundle.index}: {reply}")
            prepared.append(bundle)
        return None

    def _release_remote_bundles(self, pg_hex: str, bundles) -> None:
        """Release bundles at their agents (a rollback or a removal);
        best-effort: a dead agent's ledger dies with it."""
        for bundle in bundles:
            try:
                bundle.node.client.call("release_bundle", pg_hex, bundle.index)
            except (RpcError, OSError):
                pass

    def _reserve_bundle(self, pg_hex: str, index: int, resources: Dict[str, float],
                        owner_hex: str) -> str:
        """Agent side: grant a bundle against THIS node's ledger. Tasks
        and actors dispatched into the bundle lease from the reserved
        pool; its releases drain the admission queue like the ledger's."""
        if not self._local_node.resources.try_acquire(resources):
            return "busy"
        pool = ResourceSet(resources)
        pool.on_release = self._drain_admission
        with self._lock:
            self._hosted_bundles[(pg_hex, index)] = pool
            self._bundle_owner[(pg_hex, index)] = owner_hex
        return "ok"

    def _release_bundle(self, pg_hex: str, index: int) -> bool:
        """Agent side: detach a bundle with exact accounting. Its unused
        slice returns to the ledger now; what running tasks and actors
        still hold flows back as they release (`reconcile`). The pool is
        closed, so no restart or new lease draws from capacity the ledger
        has taken back."""
        with self._lock:
            pool = self._hosted_bundles.pop((pg_hex, index), None)
            self._bundle_owner.pop((pg_hex, index), None)
        if pool is None:
            return False
        pool.closed = True
        ledger = self._local_node.resources
        returned = pool.available()
        state = {"returned": dict(returned)}
        reconcile_lock = threading.Lock()

        def reconcile() -> None:
            # a holder released into the closed pool: forward the delta
            with reconcile_lock:
                avail = pool.available()
                delta = {k: avail.get(k, 0.0) - state["returned"].get(k, 0.0) for k in pool.total}
                pos = {k: v for k, v in delta.items() if v > 1e-9}
                for k, v in pos.items():
                    state["returned"][k] = state["returned"].get(k, 0.0) + v
            if pos:
                ledger.release(pos)

        pool.on_release = reconcile
        if returned:
            ledger.release(returned)
        return True

    def _release_bundles_owned_by(self, node_hex: str) -> int:
        """A node died: every bundle it reserved here returns to the
        ledger (its owner can never release them now)."""
        with self._lock:
            doomed = [key for key, owner in self._bundle_owner.items() if owner == node_hex]
        for key in doomed:
            self._release_bundle(*key)
        return len(doomed)

    def _record_pg_state(self, pg) -> None:
        """The scheduler's state sink: this owner's view of a group, in the
        cluster-wide GCS table. Best-effort: the owner's group is the
        truth, the table is for observers."""
        try:
            if pg.state == "REMOVED":
                self.gcs.kv_delete(pg.id.hex(), namespace=PG_NS)
                return
            self.gcs.kv_put(pg.id.hex(), {
                "pg_id": pg.id.hex(),
                "name": pg.name,
                "strategy": pg.strategy.value,
                "state": pg.state,
                "owner": self.node_id.hex(),
                "bundles": [{"index": b.index, "resources": dict(b.resources),
                             "node": b.node.node_id.hex() if b.node is not None else None}
                            for b in pg.bundles],
                "reschedules_used": pg.reschedules_used,
                "death_history": list(pg.death_history),
                "failure_reason": pg.failure_reason,
                "updated_at": time.time(),
            }, namespace=PG_NS)
        except (RpcError, OSError):
            pass

    # -------------------------------------------------------- remote actors

    def can_place_actor_remotely(self, strategy, resources):
        """Owner-side placement decision. None (stay local) or (node,
        pool, bundle): explicit NodeAffinity to a live remote node; a
        placement-group bundle reserved on a remote node (the actor leases
        from the bundle's pool on both sides; `bundle` is its (pg hex,
        index)); or default-strategy spillover when no local node has room
        now (a remote one does) or ever could."""
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            with self._lock:
                node = self._remote_nodes.get(strategy.node_id.hex())
            if node is not None and node.alive:
                return (node, node.resources, None)
            return None
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            idx = strategy.placement_group_bundle_index
            try:
                bundles = pg.bundles if idx < 0 else [pg.bundles[idx]]
            except IndexError:
                return None  # the local path reports it
            # a LOCAL bundle that could ever host the actor wins
            if any(b.node is not None and not b.node.is_remote and b.reserved is not None
                   and b.reserved.can_ever_fit(resources) for b in bundles):
                return None
            for b in bundles:
                if (b.node is not None and b.node.is_remote and b.node.alive
                        and b.reserved is not None and b.reserved.can_ever_fit(resources)):
                    return (b.node, b.reserved, (pg.id.hex(), b.index))
            return None
        if not isinstance(strategy, str) or strategy not in ("DEFAULT", "SPREAD"):
            return None

        def fits_now(node) -> bool:
            avail = node.resources.available()
            return all(avail.get(k, 0.0) >= v - 1e-9 for k, v in resources.items())

        local = [n for n in self.runtime.scheduler.nodes() if not n.is_remote and n.alive]
        if any(fits_now(n) for n in local):
            return None  # a local node with room now wins
        with self._lock:
            remotes = [n for n in self._remote_nodes.values() if n.placeable()]
        now = [n for n in remotes if fits_now(n)]
        if now:
            node = min(now, key=lambda n: n.utilization())
            return (node, node.resources, None)
        # nobody has room: wait locally if a local node ever could, else
        # queue on the least-utilized feasible remote
        if any(n.resources.can_ever_fit(resources) for n in local):
            return None
        feasible = [n for n in remotes if n.resources.can_ever_fit(resources)]
        if not feasible:
            return None
        node = min(feasible, key=lambda n: n.utilization())
        return (node, node.resources, None)

    @staticmethod
    def _actor_blob(actor_hex, c, *, resources, max_restarts) -> bytes:
        """One encoder for create_actor payloads: the creation and a
        restart on another node ship identical semantics."""
        return dumps({
            "actor_hex": actor_hex,
            "cls": c["cls"],
            "args": c["args"],
            "kwargs": c["kwargs"],
            "resources": resources,
            "bundle": c.get("bundle"),
            "max_restarts": max_restarts,
            "max_concurrency": c["max_concurrency"],
            "executor": c["executor"],
            "runtime_env": c["runtime_env"],
            "name": c["name"],
        })

    def create_remote_actor(self, node: RemoteNode, cls, args, kwargs, *, resources,
                            max_restarts, max_concurrency, name, namespace, executor,
                            runtime_env, pool=None, bundle=None) -> Tuple[ActorID, RemoteActorProxy]:
        """Host an actor on a node agent. Returns at once with a PENDING
        proxy; method calls buffer until the agent confirms. `pool` is the
        owner-side reservation's source (the node's view, or a bundle's
        reserved pool) and `bundle` the (pg hex, index) the agent leases
        from."""
        actor_id = ActorID.of(self.runtime.job_id)
        proxy = RemoteActorProxy(self, actor_id, name or getattr(cls, "__name__", "Actor"))
        creation = {
            "cls": cls, "args": args, "kwargs": kwargs,
            "resources": dict(resources or {}), "max_restarts": max_restarts,
            "max_concurrency": max_concurrency, "name": name, "namespace": namespace,
            "executor": executor, "runtime_env": runtime_env, "bundle": bundle,
        }
        if max_restarts != 0:
            # only restart-budgeted actors pin their creation payload
            proxy.creation = creation
        with self._lock:
            self.remote_actors[actor_id] = proxy
        self._spawn(self._create_actor_worker,
                    (proxy, node, creation, pool if pool is not None else node.resources),
                    f"ray_tpu_torch-ractor-create-{actor_id.hex()[:8]}")
        return actor_id, proxy

    def _create_actor_worker(self, proxy, node, c, pool) -> None:
        resources = dict(c["resources"])
        # owner-side reservation on the remote node's view, waiting like
        # local actor placement does
        while not pool.try_acquire(resources):
            if proxy.state == "DEAD" or not node.alive or self._stop.is_set():
                proxy.die("node lost before actor placement")
                return
            time.sleep(0.005)
        with proxy._lock:
            if proxy.state == "DEAD":
                pool.release(resources)  # die() saw no reservation
                return
            proxy.resources = dict(resources)
            proxy.pool = pool
            proxy.node = node
        try:
            blob = self._actor_blob(proxy.actor_id.hex(), c, resources=resources,
                                    max_restarts=c["max_restarts"])
            reply = node.client.call("create_actor", blob)
            if reply != "ok":
                raise RpcError(f"agent rejected actor creation: {reply!r}")
        except BaseException as exc:  # noqa: BLE001 - creation failure boundary
            with proxy._lock:
                restarting = proxy.state == "RESTARTING"
            if restarting:
                return  # the node died mid-create; the restart owns recovery
            proxy.die(f"remote actor creation failed: {exc!r}")
            return
        if proxy.state == "DEAD":
            # killed while the creation RPC was in flight: reap the orphan
            try:
                node.client.call("kill_actor", proxy.actor_id.hex())
            except (RpcError, OSError):
                pass
            return
        if c["name"]:
            self._record_named(c, node, proxy)
        proxy.mark_alive(node)

    def _record_named(self, c, node, proxy) -> None:
        """The cluster-wide named-actor directory: any driver resolves the
        name to (node, id) and builds its own proxy."""
        try:
            self.gcs.kv_put(f"{c['namespace']}/{c['name']}",
                            {"node_hex": node.node_id.hex(), "actor_hex": proxy.actor_id.hex()},
                            namespace=ACTOR_NS)
        except (RpcError, OSError):
            pass

    def _restart_proxy(self, proxy: RemoteActorProxy, why: str) -> None:
        """Re-create a restartable actor on a surviving feasible node. The
        handle stays valid: queued calls resume against the NEW
        incarnation (fresh state from __init__); the directory repoints."""
        c = proxy.creation
        if c is None:
            return  # killed before this thread ran
        resources = dict(c["resources"])
        node = pool = None
        if c.get("bundle") is not None:
            # a bundle actor follows its bundle: wait for the group to
            # re-reserve it, then restart on the bundle's host
            node, pool, err = self._await_rescheduled_bundle(proxy, tuple(c["bundle"]), resources)
            if node is None:
                proxy.die(f"{why}; {err}")
                return
        deadline = time.monotonic() + 30.0
        while node is None and time.monotonic() < deadline and not self._stop.is_set():
            with proxy._lock:
                if proxy.state != "RESTARTING":
                    return  # killed while we searched
            with self._lock:
                candidates = [n for n in self._remote_nodes.values()
                              if n.placeable() and n.resources.can_ever_fit(resources)]
            candidates.sort(key=lambda n: n.utilization())
            for cand in candidates:
                if cand.resources.try_acquire(resources):
                    node, pool = cand, cand.resources
                    break
            if node is None:
                time.sleep(0.2)
        if node is None:
            proxy.die(f"{why}; no surviving node can host a restart")
            return
        try:
            blob = self._actor_blob(proxy.actor_id.hex(), c, resources=resources,
                                    max_restarts=c["max_restarts"] - proxy.restarts_used)
            reply = node.client.call("create_actor", blob)
            if reply != "ok":
                raise RpcError(f"agent rejected actor restart: {reply!r}")
        except BaseException as exc:  # noqa: BLE001 - restart failure boundary
            pool.release(resources)
            proxy.die(f"{why}; restart failed: {exc!r}")
            return
        if c["name"]:
            self._record_named(c, node, proxy)
        from ..util.events import emit

        emit("WARNING", "actors",
             f"actor {proxy.display_name} restarted on node {node.node_id.hex()[:12]}",
             kind="actor.restart", node=node.node_id.hex(), reason=why)
        logger.warning("actor %s restarted on node %s (%s)",
                       proxy.display_name, node.node_id.hex()[:12], why)
        proxy.complete_restart(node, pool, resources)
        if proxy.state == "DEAD":
            try:  # killed while the restart RPC was in flight
                node.client.call("kill_actor", proxy.actor_id.hex())
            except (RpcError, OSError):
                pass

    def _await_rescheduled_bundle(self, proxy: RemoteActorProxy,
                                  bundle_key: Tuple[str, int], resources: Dict[str, float]):
        """A restarting bundle actor's new host: wait for its group to
        re-reserve the bundle, then lease the actor's resources from the
        re-reserved pool. (node, pool, None), or (None, None, reason)."""
        from .config import cfg

        pg_hex, idx = bundle_key
        pg = self.runtime.scheduler.get_placement_group(pg_hex)
        if pg is None:
            return None, None, "its placement group is gone"
        if not pg.wait_reserved(timeout=cfg.pg_reschedule_wait_s):
            return None, None, (f"placement group {pg_hex[:12]} did not re-reserve "
                                f"({pg.state}: {pg.failure_reason or 'timed out'})")
        try:
            bundle = pg.bundles[idx]
        except IndexError:
            return None, None, f"bundle {idx} does not exist"
        node, pool = bundle.node, bundle.reserved
        if node is None or not node.is_remote or not node.alive or pool is None:
            return None, None, f"bundle {idx} host is not a live agent"
        deadline = time.monotonic() + 30.0
        while not pool.try_acquire(resources):
            with proxy._lock:
                if proxy.state != "RESTARTING":
                    return None, None, "killed while waiting for the bundle"
            if time.monotonic() > deadline:
                return None, None, f"bundle {idx} pool never freed capacity for the restart"
            time.sleep(0.02)
        return node, pool, None

    def submit_remote_actor_call(self, proxy: RemoteActorProxy, method: str,
                                 args, kwargs, return_ids, trace_ctx=None) -> None:
        call = _RemoteActorCall(uuid.uuid4().hex, method, args, kwargs, return_ids)
        call.trace_ctx = trace_ctx
        proxy.submit(call)

    def kill_remote_actor(self, proxy: RemoteActorProxy) -> None:
        node, hex_ = proxy.node, proxy.actor_id.hex()
        proxy.die("killed by owner")
        proxy.stop()
        if node is not None:
            try:
                node.client.call("kill_actor", hex_)
            except (RpcError, OSError):
                pass

    def _actor_task_done(self, task_hex: str, statuses: Optional[List[Tuple[str, Any]]],
                         error_blob: Optional[bytes]) -> str:
        with self._lock:
            proxy = self._actor_calls.pop(task_hex, None)
        if proxy is None:
            return "stale"
        call = proxy.take_inflight(task_hex)
        if call is None:
            return "stale"
        store = self.runtime.object_store
        if error_blob is not None:
            try:
                error, tb = pickle.loads(error_blob)
            except Exception:
                error, tb = RuntimeError("undecodable remote actor error"), ""
            if tb and not getattr(error, "remote_traceback", None):
                try:
                    error.remote_traceback = tb
                except Exception:
                    pass
            for oid in call.return_ids:
                store.seal_error(oid, error)
            return "ok"
        self._seal_statuses(call.return_ids, statuses)
        return "ok"

    # --------------------------------------------------- agent-side hosting

    def _agent_create_actor(self, blob: bytes) -> str:
        msg = pickle.loads(blob)
        placement_pool = None
        bundle = msg.get("bundle")
        if bundle is not None:
            with self._lock:
                placement_pool = self._hosted_bundles.get(tuple(bundle))
            if placement_pool is None:
                return f"no bundle {bundle} reserved here"
        handle = self.runtime.create_actor(
            msg["cls"], tuple(msg["args"]), dict(msg["kwargs"]),
            resources=msg["resources"],
            max_restarts=msg["max_restarts"],
            max_concurrency=msg["max_concurrency"],
            executor=msg["executor"],
            runtime_env=msg["runtime_env"],
            placement_pool=placement_pool,
            _hosted=True,
        )
        with self._lock:
            self._hosted_actors[msg["actor_hex"]] = handle
        return "ok"

    def _agent_call_actor(self, blob: bytes) -> str:
        msg = pickle.loads(blob)
        with self._lock:
            handle = self._hosted_actors.get(msg["actor_hex"])
        if handle is None:
            raise KeyError(f"no hosted actor {msg['actor_hex']!r}")
        # submit into the mailbox SYNCHRONOUSLY on the owner's (single,
        # ordered) connection thread: two sequential calls must enqueue in
        # arrival order; only the result await runs on a pooled thread
        n = len(msg["return_oids"])
        with self._lock:
            self._agent_running.add(msg["task_hex"])
        try:
            from ..util import tracing

            with tracing.use_context(msg.get("trace_ctx")):
                refs = self.runtime.submit_actor_task(
                    handle._actor_id, msg["method"], tuple(msg["args"]),
                    dict(msg["kwargs"]), num_returns=n if n > 1 else 1)
        except BaseException as exc:  # noqa: BLE001 - ferried to the owner
            tb = getattr(exc, "remote_traceback", None) or traceback.format_exc()
            self._task_pool().submit(lambda m=msg, e=exc, t=tb: self._reply_actor_error(m, e, t))
            return "accepted"
        refs = refs if isinstance(refs, list) else [refs]
        self._task_pool().submit(lambda r=refs, m=msg: self._run_agent_actor_call(r, m))
        return "accepted"

    def _run_agent_actor_call(self, refs, msg: Dict[str, Any]) -> None:
        """Await a hosted actor call's result and deliver it to the owner —
        the same result plane as remote tasks."""
        try:
            values = [self.runtime.get(r) for r in refs]
        except BaseException as exc:  # noqa: BLE001 - ferried to the owner
            tb = getattr(exc, "remote_traceback", None) or traceback.format_exc()
            self._reply_actor_error(msg, exc, tb)
            return
        self._deliver_values(msg, values, "actor_task_done")

    def _reply_actor_error(self, msg: Dict[str, Any], exc: BaseException, tb: str) -> None:
        blob = _error_blob(exc, tb)
        self._deliver_with_retry(
            msg["task_hex"], msg["reply_addr"],
            lambda: self._reply_client(msg["reply_addr"]).call(
                "actor_task_done", msg["task_hex"], None, blob),
            park=lambda: self._park(msg["task_hex"], None, blob, []),
        )

    def _agent_kill_actor(self, actor_hex: str) -> bool:
        with self._lock:
            handle = self._hosted_actors.pop(actor_hex, None)
        if handle is None:
            return False
        self.runtime.kill_actor(handle, no_restart=True)
        return True

    def _agent_actor_state(self, actor_hex: str) -> str:
        with self._lock:
            handle = self._hosted_actors.get(actor_hex)
        if handle is None:
            return "DEAD"
        return self.runtime.actor_runtime(handle._actor_id).state.value

    def lookup_named_actor(self, name: str, namespace: str = "default"):
        """Resolve a cluster-registered named actor to a proxy (any
        driver, any node). None when unknown."""
        try:
            rec = self.gcs.kv_get(f"{namespace}/{name}", namespace=ACTOR_NS)
        except (RpcError, OSError):
            return None
        if not rec:
            return None
        actor_id = ActorID(rec["actor_hex"])
        with self._lock:
            proxy = self.remote_actors.get(actor_id)
        if proxy is not None:
            return proxy  # ours: it follows restarts itself
        with self._lock:
            node = self._remote_nodes.get(rec["node_hex"])
        if node is None:
            return None
        with self._lock:
            proxy = self.remote_actors.get(actor_id)
            if proxy is None:
                proxy = RemoteActorProxy(self, actor_id, name)
                proxy.mark_alive(node)
                self.remote_actors[actor_id] = proxy
        return proxy

    # ----------------------------------------------------- agent-side execute

    def _task_pool(self):
        """Agent-side execution rides the local scheduler's pooled task
        threads: a flood of small remote tasks must not churn a fresh OS
        thread each."""
        return self.runtime.scheduler._task_threads

    def _execute_task(self, blob: bytes) -> str:
        """Admission control: the arriving task acquires against THIS
        node's resource set — the one the local scheduler draws from too —
        so drivers sharing this agent cannot oversubscribe it: excess
        tasks queue here (bounded) or bounce back with "busy"."""
        msg = pickle.loads(blob)
        with self._lock:
            self._agent_running.add(msg["task_hex"])
        with self._admit_lock:
            if self._admit_queue:
                # FIFO: a new arrival never jumps tasks already waiting
                return self._queue_or_bounce_locked(msg)
        if self._try_admit(msg):
            self.agent_stats["admitted"] += 1
            return "accepted"
        with self._admit_lock:
            return self._queue_or_bounce_locked(msg)

    def _queue_or_bounce_locked(self, msg: Dict[str, Any]) -> str:  # holds-lock: _admit_lock
        if len(self._admit_queue) >= self._admit_queue_cap:
            with self._lock:
                self._agent_running.discard(msg["task_hex"])
            self.agent_stats["bounced"] += 1
            return "busy"
        self._admit_queue.append(msg)
        self.agent_stats["queued"] += 1
        return "accepted"

    def _admit_pool(self, msg: Dict[str, Any]):
        """The pool a task leases from: its bundle's reserved pool when it
        was dispatched into one, else this node's ledger. None when the
        named bundle is gone (its group was removed meanwhile)."""
        bundle = msg.get("bundle")
        if bundle is None:
            return self._local_node.resources
        with self._lock:
            return self._hosted_bundles.get(tuple(bundle))

    def _try_admit(self, msg: Dict[str, Any]) -> bool:
        """Acquire the task's resources on its admission pool and start it
        on a pooled thread. False = the pool is full right now."""
        pool = self._admit_pool(msg)
        if pool is None:
            # the bundle is gone: fail the task back to its owner
            self._task_pool().submit(lambda m=msg: self._reply_error(
                m, WorkerCrashedError(
                    f"placement-group bundle {m['bundle']} is no longer reserved on node "
                    f"{self.node_id.hex()[:12]}"), ""))
            return True
        res = msg.get("resources") or {}
        if not pool.try_acquire(res):
            return False
        # the release goes back to the pool that granted the lease, even
        # when the bundle is released meanwhile (its reconcile forwards it)
        msg["_pool"] = pool
        self._task_pool().submit(lambda m=msg: self._run_agent_task(m))
        return True

    def _drain_admission(self) -> None:
        """A release on the ledger: admit queued arrivals FIFO until it
        blocks again."""
        while True:
            with self._admit_lock:
                if not self._admit_queue:
                    return
                msg = self._admit_queue[0]
                if not self._try_admit(msg):
                    return
                self._admit_queue.popleft()

    def _run_agent_task(self, msg: Dict[str, Any]) -> None:
        """Execute a remotely submitted task in THIS process (or its
        worker pool) and report the results to the owner."""
        from ..util import logs as _logs

        threading.current_thread().name = f"ray_tpu_torch-agent-{msg['name']}-{msg['task_hex'][:6]}"
        try:
            with _logs.attribution(f"task:{msg['task_hex'][:8]}"):
                self._run_agent_task_body(msg)
        finally:
            # into the pool the lease came from: its on_release drains the
            # admission queue (the ledger) or reconciles a released bundle
            msg["_pool"].release(msg.get("resources") or {})

    def _run_agent_task_body(self, msg: Dict[str, Any]) -> None:
        from . import runtime_env as _renv
        from ..util import tracing

        task_hex = msg["task_hex"]
        # the cross-process trace link: this span parents into the
        # driver's dispatch span through the blob's trace context
        exec_span = tracing.tracer().start_span(
            "task.execute", parent=msg.get("trace_ctx"),
            lane=f"node:{self.node_id.hex()[:8]}",
            attrs={"task": msg["name"], "task_id": task_hex, "remote": True},
        )
        try:
            # the scheduler's chaos boundary, for remote tasks: kill_node
            # here takes the whole agent down
            from . import chaos

            with tracing.use_context(exec_span.context):
                chaos.maybe_inject(msg["name"])
        except BaseException as exc:  # noqa: BLE001 - ferried to the owner
            exec_span.end(status="ERROR", error=repr(exc))
            self._reply_error(msg, exc, traceback.format_exc())
            return
        if msg.get("streaming"):
            with tracing.use_context(exec_span.context):
                self._run_agent_streaming(msg)
            exec_span.end()
            return
        try:
            # args that shipped as refs (big / remote) pull NOW, on the
            # executing node; the borrow registered at unpickle time pins
            # them at the owner meanwhile
            store = self.runtime.object_store
            with tracing.use_context(exec_span.context):
                if msg.get("executor") == "process":
                    from .worker_pool import execute_process_task

                    result = execute_process_task(store, msg["func"], msg["args"],
                                                  msg["kwargs"], msg.get("runtime_env"))
                else:
                    task_args = _resolve(tuple(msg["args"]), store)
                    task_kwargs = _resolve(dict(msg["kwargs"]), store)
                    with _renv.applied(msg.get("runtime_env")):
                        result = msg["func"](*task_args, **task_kwargs)
            if msg["num_returns"] == 1:
                values = [result]
            else:
                values = list(result) if result is not None else []
                if len(values) != msg["num_returns"]:
                    raise ValueError(
                        f"Task {msg['name']} declared num_returns={msg['num_returns']} "
                        f"but returned {len(values)} values")
        except BaseException as exc:  # noqa: BLE001 - ferried to the owner
            tb = getattr(exc, "remote_traceback", None) or traceback.format_exc()
            exec_span.end(status="ERROR", error=repr(exc))
            self._reply_error(msg, exc, tb)
            return
        exec_span.end()
        with tracing.span("task.result", parent=exec_span.context,
                          lane=f"node:{self.node_id.hex()[:8]}",
                          task=msg["name"], task_id=task_hex):
            self._deliver_values(msg, values, "task_done")

    def _keep_for_owner(self, oid_hex: str, value: Any) -> Tuple[str, str, int]:
        """Seal a result here on the owner's behalf (custodial: only its
        free_object or this node's teardown releases it) and register it
        in the object directory; returns its "remote" status."""
        from .object_store import _estimate_nbytes

        oid = ObjectID(oid_hex)
        store = self.runtime.object_store
        entry = store.create(oid)
        entry.custodial = True
        store.seal(oid, value)
        try:
            self.gcs.kv_put(oid_hex, self.address, namespace=OBJDIR_NS)
        except (RpcError, OSError):
            pass  # the status (or a poll reply) carries the address anyway
        return ("remote", self.address, _estimate_nbytes(value))

    def _status(self, oid_hex: str, value: Any):
        """A small value rides in the report itself; a big one stays here
        as a placeholder the owner pulls on get()."""
        from .config import cfg
        from .object_store import _estimate_nbytes

        if _estimate_nbytes(value) <= cfg.remote_inline_max_bytes:
            return ("value", value)
        return self._keep_for_owner(oid_hex, value)

    def _deliver_values(self, msg: Dict[str, Any], values: List[Any], method: str) -> None:
        """Report the values to the owner through `method` (task_done /
        actor_task_done)."""

        def deliver() -> None:
            statuses = [self._status(oid_hex, value)
                        for oid_hex, value in zip(msg["return_oids"], values)]
            self._reply_client(msg["reply_addr"]).call(method, msg["task_hex"], statuses, None)

        self._deliver_with_retry(msg["task_hex"], msg["reply_addr"], deliver,
                                 park=lambda: self._park_values(msg, values))

    def _run_agent_streaming(self, msg: Dict[str, Any]) -> None:
        """Execute a streaming generator HERE, reporting each yield as it
        is produced (stream_item: a small value inside, a big one kept here
        as a placeholder). The stream_item reply carries the owner's
        backpressure, so it rides a DEDICATED connection — blocking it
        must not hold up other tasks' completions."""
        from . import runtime_env as _renv
        from .ids import TaskID

        task_hex = msg["task_hex"]
        task_id = TaskID(task_hex)
        store = self.runtime.object_store
        client = RpcClient(msg["reply_addr"], timeout=600.0, retries=0, token=self.token)
        try:
            try:
                task_args = _resolve(tuple(msg["args"]), store)
                task_kwargs = _resolve(dict(msg["kwargs"]), store)
                with _renv.applied(msg.get("runtime_env")):
                    result = msg["func"](*task_args, **task_kwargs)
                    if not hasattr(result, "__iter__"):
                        raise TypeError(
                            f"streaming task {msg['name']} must return an "
                            f"iterable/generator, got {type(result).__name__}")
                    for idx, item in enumerate(result):
                        oid = ObjectID.for_task_return(task_id, idx)
                        status = self._status(oid.hex(), item)
                        while True:
                            reply = client.call("stream_item", task_hex, idx, oid.hex(), status)
                            if reply != "backlogged":
                                break
                        if reply == "stale":
                            # the owner failed over or the consumer left
                            with self._lock:
                                self._agent_running.discard(task_hex)
                            return
            except BaseException as exc:  # noqa: BLE001 - ferried to the owner
                tb = getattr(exc, "remote_traceback", None) or traceback.format_exc()
                self._reply_error(msg, exc, tb)
                return
        finally:
            client.close()
        self._deliver_with_retry(
            task_hex, msg["reply_addr"],
            lambda: self._reply_client(msg["reply_addr"]).call("task_done", task_hex, [], None),
            park=lambda: self._park(task_hex, [], None, []),
        )

    def _park_values(self, msg: Dict[str, Any], values: List[Any]) -> None:
        """Seal every return value here (any size) and record a parked
        completion the owner's poll loop can claim."""
        statuses = [self._keep_for_owner(oid_hex, value)
                    for oid_hex, value in zip(msg["return_oids"], values)]
        self._park(msg["task_hex"], statuses, None,
                   [ObjectID(h) for h in msg["return_oids"]])

    def _park(self, task_hex: str, statuses, error_blob, oids) -> None:
        from .config import cfg
        from ..util.events import emit

        with self._lock:
            self._parked[task_hex] = _ParkedResult(statuses, error_blob, oids,
                                                   cfg.parked_result_ttl_s)
            self._agent_running.discard(task_hex)
        self.agent_stats["parked"] += 1
        emit("WARNING", "cluster", f"parked undeliverable completion of task {task_hex[:12]}",
             kind="task.parked")
        logger.warning("parked undeliverable completion of task %s (owner unreachable); "
                       "the owner's poll loop can reclaim it for %.0fs",
                       task_hex[:12], cfg.parked_result_ttl_s)

    def _poll_task_done(self, task_hex: str) -> Tuple[str, Any, Any]:
        """The owner's recovery probe: "parked" hands the completion over
        (idempotent), "running" means queued or executing here, "unknown"
        means no record (the agent restarted) — the owner fails over."""
        with self._lock:
            rec = self._parked.get(task_hex)
            if rec is not None:
                rec.delivered = True  # the values now belong to the owner
                return ("parked", rec.statuses, rec.error_blob)
            if task_hex in self._agent_running:
                return ("running", None, None)
        return ("unknown", None, None)

    def _sweep_parked(self) -> None:
        """Drop parked completions past their TTL. An undelivered record
        frees the values it pinned (the owner never came back); a delivered
        one drops only the record (the owner frees through free_remote)."""
        now = time.monotonic()
        with self._lock:
            expired = [(hex_, rec) for hex_, rec in self._parked.items()
                       if now >= rec.expires_at]
            for hex_, _ in expired:
                del self._parked[hex_]
        for hex_, rec in expired:
            if rec.delivered:
                continue
            logger.warning("dropping parked result of %s (owner never returned)", hex_[:12])
            for oid in rec.oids:
                self._free_object(oid.hex())

    def _deliver_with_retry(self, task_hex: str, addr: str, deliver, park=None) -> None:
        """Completion delivery survives transient owner hiccups: retries
        with fresh connections (re-pushes are safe: seal replaces); after
        `result_delivery_attempts` failures the completion is PARKED for
        the owner's poll loop instead of dropped."""
        from .config import cfg

        attempts = max(1, cfg.result_delivery_attempts)
        for attempt in range(attempts):
            try:
                deliver()
                with self._lock:
                    self._agent_running.discard(task_hex)
                return
            except (RpcError, OSError) as exc:
                with self._lock:
                    stale = self._reply_clients.pop(addr, None)
                if stale is not None:
                    stale.close()
                if attempt == attempts - 1 or self._stop.is_set():
                    logger.warning("result delivery for %s to %s failed after %d attempts: %r",
                                   task_hex, addr, attempt + 1, exc)
                    if park is not None:
                        park()
                    else:
                        with self._lock:
                            self._agent_running.discard(task_hex)
                    return
                self._stop.wait(min(1.0 * (attempt + 1), 5.0))

    def _reply_error(self, msg: Dict[str, Any], exc: BaseException, tb: str) -> None:
        blob = _error_blob(exc, tb)
        self._deliver_with_retry(
            msg["task_hex"], msg["reply_addr"],
            lambda: self._reply_client(msg["reply_addr"]).call(
                "task_done", msg["task_hex"], None, blob),
            park=lambda: self._park(msg["task_hex"], None, blob, []),
        )

    def _reply_client(self, addr: str) -> RpcClient:
        """One persistent connection per owner: pushes and the task_done
        report ride the same ordered stream."""
        with self._lock:
            client = self._reply_clients.get(addr)
            if client is None:
                client = RpcClient(addr, timeout=60.0, token=self.token)
                self._reply_clients[addr] = client
            return client

    # ------------------------------------------------------- object plumbing

    def _fetch_remote(self, object_id: ObjectID, address: str) -> Any:
        return fetch_object(address, object_id.hex(), token=self.token)

    def _locate(self, object_id: ObjectID) -> Optional[str]:
        return self.gcs.kv_get(object_id.hex(), namespace=OBJDIR_NS)

    def _free_object(self, oid_hex: str) -> bool:
        self.runtime.object_store.free(ObjectID(oid_hex))
        try:
            self.gcs.kv_delete(oid_hex, namespace=OBJDIR_NS)
        except (RpcError, OSError):
            pass
        return True

    def _borrow_object(self, oid_hex: str, borrower: str) -> bool:
        """A peer unpickled one of our refs: pin the value until it
        unborrows."""
        return self.runtime.object_store.add_borrow(ObjectID(oid_hex), borrower)

    def _unborrow_object(self, oid_hex: str, borrower: str) -> bool:
        self.runtime.object_store.remove_borrow(ObjectID(oid_hex), borrower)
        return True

    def _enqueue_free(self, object_id: ObjectID, address: str) -> None:
        # called under store entry locks: hand off, never block
        self._free_queue.put(("free_object", object_id.hex(), address))

    def enqueue_borrow(self, object_id: ObjectID, owner_addr: str) -> None:
        """Register this process as a borrower at the owner, on the
        dedicated (retrying) borrow channel. A per-(object, owner) latch
        keeps the order with the eventual unborrow: a retried borrow can
        never land AFTER its own unborrow and pin the owner forever."""
        with self._lock:
            self._borrow_state[(object_id.hex(), owner_addr)] = "queued"
        self._borrow_queue.put(("borrow_object", object_id.hex(), owner_addr))

    def _enqueue_unborrow(self, object_id: ObjectID, owner_addr: str) -> None:
        key = (object_id.hex(), owner_addr)
        with self._lock:
            state = self._borrow_state.pop(key, None)
        if state == "sent":
            self._borrow_queue.put(("unborrow_object", object_id.hex(), owner_addr))
        # "queued": the borrow is still in flight — popping the state makes
        # the loop drop it, so no pin lands. None: it failed for good.

    def _borrow_loop(self) -> None:
        """Borrow registrations pin the owner's value, so unlike frees
        they RETRY (re-enqueued with backoff). Short client timeouts: one
        unreachable owner must not hold up registrations to healthy ones."""
        clients: Dict[str, RpcClient] = {}
        max_attempts = 8
        while not self._stop.is_set():
            try:
                item = self._borrow_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            op, oid_hex, addr = item[:3]
            attempt = item[3] if len(item) > 3 else 0
            key = (oid_hex, addr)
            if op == "borrow_object":
                with self._lock:
                    if self._borrow_state.get(key) != "queued":
                        continue  # ref already released: borrow cancelled
            client = clients.get(addr)
            if client is None:
                client = RpcClient(addr, timeout=3.0, retries=0, token=self.token)
                clients[addr] = client
            try:
                client.call(op, oid_hex, self.address)
            except (RpcError, OSError) as exc:
                client.close()
                clients.pop(addr, None)
                if attempt + 1 < max_attempts and not self._stop.is_set():
                    self._stop.wait(min(0.1 * (attempt + 1), 0.5))
                    self._borrow_queue.put((op, oid_hex, addr, attempt + 1))
                else:
                    logger.warning("%s for %s at %s dropped after %d attempts: %r",
                                   op, oid_hex, addr, attempt + 1, exc)
                    if op == "borrow_object":
                        with self._lock:
                            self._borrow_state.pop(key, None)
                        entry = self.runtime.object_store.entry(ObjectID(oid_hex))
                        if entry is not None:
                            entry.borrow_failed = True
                continue
            if op == "borrow_object":
                with self._lock:
                    if self._borrow_state.get(key) == "queued":
                        self._borrow_state[key] = "sent"
                    else:
                        # released while we were sending: send the
                        # unborrow that path skipped
                        self._borrow_queue.put(("unborrow_object", oid_hex, addr))
        for client in clients.values():
            client.close()

    def _free_loop(self) -> None:
        # short-timeout, no-retry clients: a free aimed at a dead node must
        # not hold up frees to healthy ones
        free_clients: Dict[str, RpcClient] = {}
        while not self._stop.is_set():
            try:
                op, oid_hex, addr = self._free_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            client = free_clients.get(addr)
            if client is None:
                client = RpcClient(addr, timeout=3.0, retries=0, token=self.token)
                free_clients[addr] = client
            try:
                client.call(op, oid_hex)
            except (RpcError, OSError):
                # best-effort: a dead node's store dies with it
                client.close()
                free_clients.pop(addr, None)
        for client in free_clients.values():
            client.close()

    # ------------------------------------------------------------------ misc

    def fanout_nodes(self, method: str, *args, placeholder=None):
        """Call `method(*args)` on every live remote node's agent: {node_hex:
        result}; a node that fails or does not answer maps to
        `placeholder(exc)` (None without one), never dropped."""
        out: Dict[str, Any] = {}
        with self._lock:
            nodes = list(self._remote_nodes.values())
        for node in nodes:
            if not node.alive:
                continue
            try:
                out[node.node_id.hex()] = node.client.call(method, *args)
            except Exception as exc:  # noqa: BLE001 - a partial view is fine
                out[node.node_id.hex()] = placeholder(exc) if placeholder is not None else None
        return out

    def _node_logs(self, n: int = 200) -> List[str]:
        """This node's captured log tail (util/logs)."""
        from ..util import logs as _logs

        return _logs.tail(int(n))

    def _node_events(self, since_seq: int = 0, limit: int = 500) -> List[Dict[str, Any]]:
        """This node's structured event tail (util/events)."""
        from ..util.events import events

        return events().list(since_seq=int(since_seq), limit=int(limit))

    def _node_spans(self, trace_id: Optional[str] = None,
                    limit: int = 10_000) -> List[Dict[str, Any]]:
        """This node's completed trace spans (util/tracing), which the
        state API stitches into one trace by trace_id."""
        from ..util.tracing import tracer

        return tracer().spans(trace_id, int(limit))

    def _metrics_snapshot(self) -> str:
        """This node's Prometheus exposition, which the head merges under
        per-sample node_id labels (/metrics/cluster)."""
        from ..util.metrics import registry

        return registry().prometheus_text()

    def _node_stats(self) -> Dict[str, Any]:
        """This node's live stats snapshot (core/stats.py)."""
        collector = getattr(self.runtime, "node_stats", None)
        return collector.snapshot() if collector is not None else {}

    def _profile_capture(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        """The agent's arm of a capture's fan-out: a time-boxed device
        trace + host profile HERE, its bounded artifacts returned in the
        reply, with the node kept live meanwhile (`quiet`); a degraded
        capture comes back in the meta, never as an exception."""
        from ..util import profiling
        from .config import cfg

        duration_s = spec.get("duration_s") or cfg.profile_default_duration_s
        with self.quiet(float(duration_s) + profiling.CAPTURE_HOLD_S):
            return profiling.capture_local_profile(
                duration_s, device=bool(spec.get("device", True)),
                host=bool(spec.get("host", True)), profile_id=spec.get("profile_id", ""))

    def _node_info(self) -> Dict[str, Any]:
        return {
            "node_id": self.node_id.hex(),
            "address": self.address,
            "is_head": self.is_head,
            "pid": os.getpid(),
            "resources": dict(self._local_node.resources.total),
            "available": dict(self._local_node.resources.available()),
        }

    def _shutdown_node(self) -> str:
        """Graceful stop (cluster_utils, SIGTERM): the agent's main loop
        watches shutdown_requested."""
        self.shutdown_requested.set()
        return "ok"

    def _unhook_scheduler(self) -> None:
        sched = self.runtime.scheduler
        sched.remote_dispatcher = None
        sched.remote_bundle_reserver = None
        sched.remote_bundle_releaser = None
        sched.pg_state_sink = None

    def stop(self) -> None:
        """Leave the cluster: stop the loops and every proxy, deregister,
        close the clients and the server, and join every thread this
        context started."""
        self._stop.set()
        self._local_node.resources.on_release = None
        self._unhook_scheduler()
        timer = self._preempt_timer
        if timer is not None:
            timer.cancel()
        with self._lock:
            proxies = list(self.remote_actors.values())
            self.remote_actors.clear()
        for proxy in proxies:
            proxy.stop()
        try:
            self.gcs.kv_delete(self.node_id.hex(), namespace=NODE_NS)
        except (RpcError, OSError):
            pass
        for th in self._loops:
            th.join(timeout=10.0)
        deadline = time.monotonic() + 10.0
        for proxy in proxies:
            proxy.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._lock:
            workers = list(self._workers)
        for th in workers:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._lock:
            clients = list(self._reply_clients.values())
            self._reply_clients.clear()
            nodes = list(self._remote_nodes.values())
            self._remote_nodes.clear()
        for c in clients:
            c.close()
        for n in nodes:
            n.client.close()
        self.gcs.close()
        self.server.stop()


# ----------------------------------------------------------------- entry points


def start_head(runtime, *, port: int = 0, token: Optional[str] = None,
               bind_host: Optional[str] = None) -> ClusterContext:
    """Make this process the cluster head: serve its GCS over RPC and
    join as the first node."""
    from .config import cfg
    from .gcs_service import serve_gcs

    host = bind_host or cfg.cluster_bind_host
    if host not in ("127.0.0.1", "localhost") and not token:
        raise ValueError("a head bound off-localhost requires a cluster token")
    gcs_server = serve_gcs(runtime.gcs, host=host, port=port, token=token,
                           stale_s=cfg.node_stale_s)
    try:
        ctx = ClusterContext(runtime, gcs_server.url, token=token, is_head=True,
                             bind_host=host)
    except BaseException:
        gcs_server.stop()
        raise
    ctx.gcs_server = gcs_server
    return ctx


def join_cluster(runtime, address: str, *, token: Optional[str] = None,
                 bind_host: Optional[str] = None) -> ClusterContext:
    """Join an existing cluster as a worker node."""
    return ClusterContext(runtime, address, token=token, is_head=False, bind_host=bind_host)
