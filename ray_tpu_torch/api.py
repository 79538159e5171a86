"""Public API: init/shutdown, @remote, get/put/wait, actors, placement groups.

Port of `ray_tpu/api.py`. `num_gpus=` takes the place of `num_tpus=` in
`init`, `remote` and `.options`: it asks for the `GPU` resource, which
`init` detects from the CUDA devices of the process
(`core/resources.detect_gpu_resources`). A task or actor asking for a GPU
on a node without one is infeasible and fails with OutOfResourcesError; it
never runs on the CPU instead.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .core import runtime as _rt
from .core.resources import ResourceDict
from .core.runtime import ActorHandle, ObjectRef
from .core.scheduler import PlacementGroup


# ------------------------------------------------------------------- lifecycle


def init(
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[ResourceDict] = None,
    num_nodes: int = 1,
    object_store_capacity: Optional[int] = None,
    spill_dir: Optional[str] = None,
    detect_accelerators: bool = True,
    ignore_reinit_error: bool = True,
    labels: Optional[Dict[str, str]] = None,
    head: bool = False,
    address: Optional[str] = None,
    cluster_token: Optional[str] = None,
    gcs_port: int = 0,
    _system_config: Optional[Dict[str, Any]] = None,
) -> _rt.Runtime:
    """Start the in-process runtime.

    `num_nodes > 1` creates multiple logical nodes in one process — the
    multi-node-without-a-cluster trick the reference uses for testing.
    With `detect_accelerators` (the default) and no `num_gpus`, each node
    advertises the process's CUDA devices as `GPU`.

    `head=True` makes this process a cluster head (its GCS served over RPC
    on `gcs_port`, 0 = ephemeral); `address="host:port"` joins the head
    whose GCS listens there, as a node. `cluster_token` authenticates
    every cluster connection (required off localhost). Node agents start
    with `python -m ray_tpu_torch start --address ...` or
    `cluster_utils.Cluster.add_node`.

    `_system_config` overrides central config flags for this process
    (`ray_tpu_torch.core.config.cfg`).
    """
    if _system_config and _rt.is_initialized():
        # Components capture flags at construction; silently accepting an
        # override that can no longer take effect would be a lie (the
        # reference likewise rejects _system_config on reconnect).
        raise RuntimeError(
            "_system_config cannot be applied: the runtime is already "
            "initialized. Call shutdown() first."
        )
    if _system_config:
        from .core.config import cfg

        cfg.set(**_system_config)
    if _rt.is_initialized():
        if not ignore_reinit_error:
            raise RuntimeError("ray_tpu_torch.init() called twice")
        return _rt.get_runtime()
    return _rt.init_runtime(
        num_cpus=num_cpus,
        num_gpus=num_gpus,
        resources=resources,
        num_nodes=num_nodes,
        object_store_capacity=object_store_capacity,
        spill_dir=spill_dir,
        detect_accelerators=detect_accelerators,
        labels=labels,
        head=head,
        address=address,
        cluster_token=cluster_token,
        gcs_port=gcs_port,
    )


def shutdown() -> None:
    _rt.shutdown_runtime()


def is_initialized() -> bool:
    return _rt.is_initialized()


def _runtime() -> _rt.Runtime:
    return _rt.get_or_init_runtime()


# --------------------------------------------------------------------- objects


def put(value: Any) -> ObjectRef:
    return _runtime().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None) -> Any:
    return _runtime().get(refs, timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    return _runtime().wait(refs, num_returns=num_returns, timeout=timeout)


def cancel(ref: ObjectRef) -> bool:
    return _runtime().cancel(ref)


# ----------------------------------------------------------------------- tasks


_DEFAULT_TASK_OPTIONS: Dict[str, Any] = dict(
    num_cpus=None,
    num_gpus=None,
    resources=None,
    num_returns=1,
    max_retries=0,
    retry_exceptions=False,
    scheduling_strategy="DEFAULT",
    name=None,
    runtime_env=None,
    executor="thread",  # or "process": a pooled OS worker process (GIL-free)
    stream_max_backlog=None,  # streaming producers: block when consumer lags
    locality_hint=None,  # NodeID: soft preference for the block-holding node
)

_DEFAULT_ACTOR_OPTIONS: Dict[str, Any] = dict(
    num_cpus=None,
    num_gpus=None,
    resources=None,
    max_restarts=0,
    max_concurrency=1,
    name=None,
    namespace="default",
    lifetime=None,
    scheduling_strategy="DEFAULT",
    executor="thread",  # or "process": the instance in a worker process of its own
    runtime_env=None,  # process actors only
)


def _build_resources(options: Dict[str, Any], default_cpu: float) -> ResourceDict:
    res: ResourceDict = dict(options.get("resources") or {})
    num_cpus = options.get("num_cpus")
    num_gpus = options.get("num_gpus")
    res["CPU"] = float(num_cpus) if num_cpus is not None else default_cpu
    if num_gpus is not None:
        res["GPU"] = float(num_gpus)
    return res


class RemoteFunction:
    """Handle produced by @remote on a function."""

    def __init__(self, func, options: Dict[str, Any]):
        self._func = func
        self._options = options
        functools.update_wrapper(self, func)

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._options)
        unknown = set(overrides) - set(_DEFAULT_TASK_OPTIONS)
        if unknown:
            raise TypeError(f"Unknown task options: {sorted(unknown)}")
        merged.update(overrides)
        return RemoteFunction(self._func, merged)

    def remote(self, *args, **kwargs):
        opts = self._options
        return _runtime().submit_task(
            self._func,
            args,
            kwargs,
            name=opts.get("name") or self._func.__name__,
            num_returns=opts["num_returns"],
            resources=_build_resources(opts, default_cpu=1.0),
            max_retries=opts["max_retries"],
            retry_exceptions=opts["retry_exceptions"],
            scheduling_strategy=opts["scheduling_strategy"],
            runtime_env=opts.get("runtime_env"),
            executor=opts.get("executor", "thread"),
            stream_max_backlog=opts.get("stream_max_backlog"),
            locality_hint=opts.get("locality_hint"),
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._func.__name__} cannot be called directly; "
            f"use .remote()"
        )


class ActorClass:
    """Handle produced by @remote on a class."""

    def __init__(self, cls: type, options: Dict[str, Any]):
        self._cls = cls
        self._options = options

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._options)
        unknown = set(overrides) - set(_DEFAULT_ACTOR_OPTIONS)
        if unknown:
            raise TypeError(f"Unknown actor options: {sorted(unknown)}")
        merged.update(overrides)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._options
        return _runtime().create_actor(
            self._cls,
            args,
            kwargs,
            resources=_build_resources(opts, default_cpu=1.0),
            max_restarts=opts["max_restarts"],
            max_concurrency=opts["max_concurrency"],
            name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            scheduling_strategy=opts["scheduling_strategy"],
            lifetime=opts.get("lifetime"),
            executor=opts.get("executor", "thread"),
            runtime_env=opts.get("runtime_env"),
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use .remote()"
        )


def remote(*args, **kwargs):
    """`@remote` / `@remote(num_cpus=..., num_gpus=..., resources=...)`.

    Works on functions (→ RemoteFunction) and classes (→ ActorClass).
    """

    def decorate(target):
        if isinstance(target, type):
            opts = dict(_DEFAULT_ACTOR_OPTIONS)
            unknown = set(kwargs) - set(opts)
            if unknown:
                raise TypeError(f"Unknown actor options: {sorted(unknown)}")
            opts.update(kwargs)
            return ActorClass(target, opts)
        opts = dict(_DEFAULT_TASK_OPTIONS)
        unknown = set(kwargs) - set(opts)
        if unknown:
            raise TypeError(f"Unknown task options: {sorted(unknown)}")
        opts.update(kwargs)
        return RemoteFunction(target, opts)

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return decorate


# ---------------------------------------------------------------------- actors


def kill(handle: ActorHandle, *, no_restart: bool = True) -> None:
    _runtime().kill_actor(handle, no_restart=no_restart)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    return _runtime().get_actor(name, namespace)


def list_actors() -> List[Dict[str, Any]]:
    return _runtime().list_actors()


# ------------------------------------------------------------ placement groups


def placement_group(
    bundles: Sequence[ResourceDict], strategy: str = "PACK", name: str = "",
    max_reschedules: Optional[int] = None,
) -> PlacementGroup:
    """Reserve a gang of bundles, all or nothing (PACK, SPREAD,
    STRICT_PACK, STRICT_SPREAD), on this process's nodes or on node
    agents. `max_reschedules` bounds the re-reservations after a bundle's
    host dies (None: `cfg.pg_reschedule_budget`; 0: the first death fails
    the group)."""
    return _runtime().create_placement_group(
        bundles, strategy, name, max_reschedules=max_reschedules
    )


def remove_placement_group(pg: PlacementGroup) -> None:
    _runtime().remove_placement_group(pg)


# ----------------------------------------------------------------- cluster info


def cluster_resources() -> ResourceDict:
    return _runtime().cluster_resources()


def available_resources() -> ResourceDict:
    return _runtime().available_resources()


def nodes() -> List[Dict[str, Any]]:
    return [
        {
            "node_id": n.node_id.hex(),
            "alive": n.alive,
            "is_head": n.is_head,
            "resources": n.resources.total,
            "labels": dict(n.labels),
        }
        for n in _runtime().scheduler.nodes()
    ]
