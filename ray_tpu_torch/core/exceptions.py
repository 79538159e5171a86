"""Typed errors of the runtime, the serving plane and the profiling cost
layer.

Port of `ray_tpu/core/exceptions.py` without the errors of the cluster
(head unavailable, stale epoch), which come with multi-node clusters. A
copy, not an import: the port imports nothing of `ray_tpu`.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class RuntimeNotInitializedError(RayTpuError):
    pass


class TaskError(RayTpuError):
    """A remote task raised; re-raised at `get` with the remote traceback.

    The original exception is kept as `.cause`, so callers dispatch on its
    type through `unwrap_error`.
    """

    def __init__(self, function_name: str, cause: BaseException, tb: Optional[str] = None):
        self.function_name = function_name
        self.cause = cause
        self.remote_traceback = tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        super().__init__(
            f"task {function_name} failed:\n{self.remote_traceback}"
        )

    def __reduce__(self):
        return (TaskError, (self.function_name, self.cause, self.remote_traceback))


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    def __init__(self, actor_id, reason: str = "actor died"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id} is dead: {reason}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id, self.reason))


class ActorUnavailableError(ActorError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    def __init__(self, object_id, note: str = ""):
        self.object_id = object_id
        self.note = note
        super().__init__(f"Object {object_id} was lost or evicted. {note}")

    def __reduce__(self):
        return (ObjectLostError, (self.object_id, self.note))


class TaskCancelledError(RayTpuError):
    pass


class ProfilingError(RayTpuError):
    """A profiling operation failed in a way the caller can act on: the
    cost layer could not count a step, or was given a step time that is
    not positive."""


class RequestTimeoutError(RayTpuError, TimeoutError):
    """A serve request outlived its end-to-end deadline.

    Raised router-side (the deadline expired while queued or in flight)
    and engine-side (the request expired before submit, while it queued,
    or mid-generation: its lane is evicted). Subclasses TimeoutError so
    generic timeout handlers still fire.
    """


class BackPressureError(RayTpuError):
    """Admission control shed this request: the deployment's queue bound
    (`max_queued_requests`), an engine's admit-queue bound, or a tenant's
    token-bucket quota was full. Retryable by the client after backoff —
    HTTP layers map it to 429 with a Retry-After header.

    ``retry_after_s`` carries the computed backoff when the shedder knows
    it (the tenant bucket's refill time, the router's queue drain-rate
    estimate); HTTP layers fall back to 1 second when it is None.
    """

    def __init__(
        self,
        message: str = "request shed by admission control",
        retry_after_s: Optional[float] = None,
    ):
        self.retry_after_s = retry_after_s
        super().__init__(message)

    def __reduce__(self):
        args = self.args[0] if self.args else "request shed by admission control"
        return (BackPressureError, (args, self.retry_after_s))


class ReplicaDrainingError(RayTpuError):
    """The picked replica is DRAINING (scale-down/redeploy): it finishes
    in-flight work but accepts no new requests. The router treats this as
    retryable and fails over to a live replica."""


class DeploymentUnavailableError(RayTpuError):
    """A deployment currently has no routable replicas (all dead or
    draining). HTTP layers map it to 503."""


def unwrap_error(err: BaseException) -> BaseException:
    """Peel TaskError wrappers off an exception that crossed task/actor
    boundaries, returning the innermost cause — the type callers (router
    retry policy, HTTP status mapping) actually dispatch on."""
    seen = 0
    while isinstance(err, TaskError) and err.cause is not None and seen < 16:
        err = err.cause
        seen += 1
    return err


class OutOfResourcesError(RayTpuError):
    """A task requires resources no node in the cluster can ever satisfy."""


class ObjectStoreFullError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(RayTpuError):
    pass


class HeadUnavailableError(RayTpuError, ConnectionError):
    """The GCS head is unreachable and the client's bounded retry budget
    (``gcs_client_retry_s``) is exhausted.

    Subclasses ConnectionError (an OSError) so every ``except (RpcError,
    OSError)`` degraded-mode catch site — heartbeat loops, watch loops —
    handles it unchanged, while typed callers can tell "head down" from a
    one-off transport fault.
    """

    def __init__(self, message: str = "GCS head unreachable", *, outage_s: float = 0.0):
        self.outage_s = outage_s
        super().__init__(message)

    def __reduce__(self):
        args = self.args[0] if self.args else "GCS head unreachable"
        return (_rebuild_head_unavailable, (args, self.outage_s))


def _rebuild_head_unavailable(message, outage_s):
    return HeadUnavailableError(message, outage_s=outage_s)


class StaleEpochError(RayTpuError):
    """A GCS write carried a cluster epoch older than the head's current
    one: the writer is a zombie from before a head restart and must stop
    driving the cluster.

    Deliberately NOT an OSError: transport-retry wrappers must never
    retry a fenced write — the fix is to re-adopt the current epoch
    (live agents) or stand down (zombies).
    """

    def __init__(self, message: str = "write fenced: stale cluster epoch",
                 writer_epoch: Optional[int] = None,
                 head_epoch: Optional[int] = None):
        self.writer_epoch = writer_epoch
        self.head_epoch = head_epoch
        super().__init__(message)

    def __reduce__(self):
        args = self.args[0] if self.args else "write fenced: stale cluster epoch"
        return (StaleEpochError, (args, self.writer_epoch, self.head_epoch))
