"""A multi-process gang hosted BY the cluster: one process actor per
placement-group bundle, one bundle per node.

Port of `ray_tpu/train/cluster_gang.py`. `ClusterWorkerGroup` reserves a
placement group (STRICT_SPREAD by default: one bundle per node agent) and
starts one `executor="process"` actor in each bundle, on whichever agent
the two-phase reservation put it (`core/cluster.py`), so node agents on N
hosts and the process that drives them make one torch.distributed job,
scheduled and watched by the cluster. It has `MultihostWorkerGroup`'s surface (start /
run_async / poll / finish / shutdown), so `TrainController` drives it
through `group_factory`.

Rendezvous: where JAX's members call `jax.distributed.initialize` with a
coordinator, each member here calls `init_process_group(backend,
init_method="tcp://<coordinator>", rank, world_size, timeout)`; rank 0's
process, on bundle 0's host, holds the store at the coordinator's
address. The backend is `multihost.default_backend` in the member's
process: NCCL where each rank can have a card of its own, gloo where
ranks share one or run on the CPU. The timeout (`timeout_s`) bounds every
collective, so a rank whose peer died raises instead of hanging; the
controller meanwhile sees the dead member through the actor plane and
tears the gang down. `destroy_process_group` runs when the loop ends.

Re-mesh: pass an existing `pg` (shared across the controller's attempts)
and `start()` waits for it to be RESERVED with every bundle on a node that
answers and is not draining, i.e. for a RESCHEDULING pass after a node
death (a rank may notice the death before the heartbeats do), or for a
preempted node to die and its bundle to move; then it elects a coordinator on the
CURRENT bundle 0 host and builds the gang on whatever nodes hold the
bundles now. An external pg is never removed by `shutdown()`.

Reports stream back through the actor plane (the `poll` method), and the
controller's preemption flags ride the same call, so nothing assumes a
filesystem shared between this process and the hosts. A member exits when its
agent dies, as a process on a lost host would (a parent watch).

What differs from JAX, and why: a member's process group gets the
group's `timeout_s` (JAX's coordination service has its own heartbeat
timeouts), and `start()` also waits out bundles on draining or silent
nodes (JAX builds the new gang there, and it dies again under it).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..core.scheduler import PlacementGroupSchedulingStrategy
from .multihost import _free_port


class _GangHostActor:
    """One gang member: runs the user's train loop on a thread of its own
    OS process (a process-executor actor), so the actor's mailbox stays
    free for polls."""

    def __init__(self):
        self._reports: List[tuple] = []
        self._done = False
        self._error: Optional[str] = None
        self._result: Any = None
        self._session: Any = None  # set once the loop thread builds it
        self._watch_parent()

    @staticmethod
    def _watch_parent() -> None:
        """Exit when the hosting agent dies: the member is a process of
        that host, and a rank that outlives it would hold the gang's
        rendezvous port and its device memory."""
        parent = os.getppid()

        def watch() -> None:
            while True:
                time.sleep(0.5)
                if os.getppid() != parent:
                    os._exit(1)

        threading.Thread(target=watch, daemon=True, name="gang-parent-watch").start()

    def start(self, train_fn: Callable, config, coordinator: str,
              num_processes: int, process_id: int, run_name: str,
              init_distributed: bool = True, backend: Optional[str] = None,
              timeout_s: float = 600.0) -> bool:
        def go() -> None:
            import datetime

            from .multihost import default_backend
            from .session import Session, TrainContext, _set_session

            outer = self

            class _ListSession(Session):
                def report(self, metrics, checkpoint_step=None, checkpoint=None):
                    super().report(metrics, checkpoint_step, checkpoint)
                    outer._reports.append((dict(metrics), checkpoint_step,
                                           self.context.world_rank, time.time()))

            distributed = num_processes > 1 and init_distributed
            dist = None
            try:
                if distributed:
                    import torch
                    import torch.distributed as dist

                    name = backend or default_backend(num_processes)
                    if name == "nccl":
                        torch.cuda.set_device(process_id % torch.cuda.device_count())
                    dist.init_process_group(
                        name, init_method=f"tcp://{coordinator}", rank=process_id,
                        world_size=num_processes,
                        timeout=datetime.timedelta(seconds=timeout_s))
                ctx = TrainContext(world_rank=process_id, world_size=num_processes,
                                   run_name=run_name)
                session = _ListSession(ctx)
                outer._session = session
                _set_session(session)
                try:
                    self._result = train_fn(config) if config is not None else train_fn()
                finally:
                    _set_session(None)
                    if dist is not None and dist.is_initialized():
                        dist.destroy_process_group()
            except BaseException as exc:  # noqa: BLE001 - ferried through poll
                import traceback

                self._error = f"{exc!r}\n{traceback.format_exc()}"
            finally:
                self._done = True

        threading.Thread(target=go, daemon=True, name="gang-train").start()
        return True

    def poll(self, since: int, should_checkpoint: bool = False,
             preempted: bool = False, preempt_deadline: float = 0.0) -> Dict[str, Any]:
        if (should_checkpoint or preempted) and self._session is not None:
            self._session.set_preemption(should_checkpoint, preempted, preempt_deadline)
        return {"reports": self._reports[since:], "done": self._done, "error": self._error}

    def result(self):
        if self._error is not None:
            raise RuntimeError(f"gang member failed: {self._error}")
        return self._result

    def ping(self) -> str:
        return "ok"

    def where(self) -> Dict[str, int]:
        """This member's pid and its parent's (the hosting agent)."""
        return {"pid": os.getpid(), "ppid": os.getppid()}


class ClusterWorkerGroup:
    """MultihostWorkerGroup's sibling whose members are cluster-hosted
    process actors in a placement group (one bundle per node by
    default)."""

    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Optional[Dict[str, float]] = None,
        run_name: str = "train_run",
        env_per_worker: Optional[List[Dict[str, str]]] = None,
        placement_strategy: str = "STRICT_SPREAD",
        pg: Any = None,
        init_distributed: bool = True,
        pg_wait_s: float = 60.0,
        backend: Optional[str] = None,
        timeout_s: float = 600.0,
    ):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker or {"CPU": 1.0})
        self.run_name = run_name
        self.env_per_worker = env_per_worker
        self.placement_strategy = placement_strategy
        self.pg = pg
        self._owns_pg = pg is None
        self.init_distributed = init_distributed
        self.pg_wait_s = pg_wait_s
        self.backend = backend
        self.timeout_s = timeout_s
        self.workers: List[Any] = []
        self._coordinator: Optional[str] = None

    def _wait_placeable(self) -> None:
        """Park until the group holds a live reservation with every bundle
        on a node that answers and is not draining: a preempted host's
        bundle moves once it dies, a dead host's once the heartbeats
        declare it."""
        from ..core.health import probe_agent

        deadline = time.monotonic() + self.pg_wait_s
        while True:
            if not self.pg.wait_reserved(timeout=max(0.0, deadline - time.monotonic())):
                raise RuntimeError(
                    f"placement group for {self.run_name} is not reservable "
                    f"({self.pg.state}): {self.pg.failure_reason or 'timed out'}")
            unfit = [b.index for b in self.pg.bundles
                     if b.node is not None and (b.node.draining or not probe_agent(b.node))]
            if not unfit:
                return
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"placement group for {self.run_name}: bundles {unfit} still sit on a "
                    f"draining or silent node after {self.pg_wait_s} s")
            time.sleep(0.05)

    def start(self) -> None:
        if self.pg is None:
            bundles = [dict(self.resources_per_worker) for _ in range(self.num_workers)]
            self.pg = api.placement_group(bundles, strategy=self.placement_strategy,
                                          name=f"{self.run_name}-gang")
            self._owns_pg = True
            self.pg.ready(timeout=60)
        elif len(self.pg.bundles) < self.num_workers:
            raise ValueError(f"placement group has {len(self.pg.bundles)} bundles; "
                             f"gang needs {self.num_workers}")
        self._wait_placeable()
        # the coordinator lives in rank 0's process, on bundle 0's host:
        # a remote bundle 0 advertises its agent's host, a local one the
        # address this process registered with. The port is picked here,
        # free here and assumed free there (JAX's race too).
        node0 = self.pg.bundles[0].node
        if getattr(node0, "is_remote", False):
            host = node0.agent_addr.split(":")[0]
        else:
            ctx = getattr(api._runtime(), "cluster", None)
            host = ctx.address.split(":")[0] if ctx is not None else "127.0.0.1"
        self._coordinator = f"{host}:{_free_port()}"
        from ..util.events import emit

        emit("INFO", "train", f"gang {self.run_name}: coordinator elected at {self._coordinator}",
             kind="train.coordinator",
             bundle0=node0.node_id.hex() if node0 is not None else None)
        host_cls = api.remote(_GangHostActor)
        per = dict(self.resources_per_worker)
        num_cpus = per.pop("CPU", 0.0)
        num_gpus = per.pop("GPU", 0.0)
        for rank in range(self.num_workers):
            env = dict(self.env_per_worker[rank]) if self.env_per_worker else {}
            self.workers.append(host_cls.options(
                num_cpus=num_cpus,
                num_gpus=num_gpus or None,
                resources=per,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    self.pg, placement_group_bundle_index=rank),
                executor="process",
                runtime_env={"env_vars": env} if env else None,
            ).remote())
        # the liveness check: every member answers before the loop starts
        api.get([w.ping.remote() for w in self.workers], timeout=120)

    def where(self) -> List[Dict[str, int]]:
        """Each member's pid and its hosting agent's pid, by rank."""
        return api.get([w.where.remote() for w in self.workers], timeout=60)

    def run_async(self, train_fn: Callable, config) -> List[Any]:
        acks = [w.start.remote(train_fn, config, self._coordinator, self.num_workers, rank,
                               self.run_name, self.init_distributed, self.backend,
                               self.timeout_s)
                for rank, w in enumerate(self.workers)]
        api.get(acks, timeout=120)  # every member launched its loop
        return list(self.workers)

    def poll(self, since: List[int], should_checkpoint: bool = False,
             preempted: bool = False, preempt_deadline: float = 0.0) -> List[Dict[str, Any]]:
        return api.get([w.poll.remote(s, should_checkpoint, preempted, preempt_deadline)
                        for w, s in zip(self.workers, since)], timeout=60)

    def finish(self, result_refs, timeout: Optional[float] = None):
        return api.get([w.result.remote() for w in self.workers], timeout=timeout)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                api.kill(w)
            except Exception:  # noqa: BLE001 - a member already gone
                pass
        if self.pg is not None and self._owns_pg:
            try:
                api.remove_placement_group(self.pg)
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
            self.pg = None
        self.workers = []
