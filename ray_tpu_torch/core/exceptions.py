"""Typed errors of the serving plane and the profiling cost layer.

Port of the part of `ray_tpu/core/exceptions.py` that the port raises:
the base class, the deadline error, the admission-control shed and the
profiling error. A copy, not an import: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class ProfilingError(RayTpuError):
    """A profiling operation failed in a way the caller can act on: the
    cost layer could not count a step, or was given a step time that is
    not positive."""


class RequestTimeoutError(RayTpuError, TimeoutError):
    """A serve request outlived its end-to-end deadline.

    Raised engine-side when the request expired before submit, while it
    queued, or mid-generation (its lane is evicted). Subclasses
    TimeoutError so generic timeout handlers still fire.
    """


class BackPressureError(RayTpuError):
    """Admission control shed this request: an engine's admit-queue bound
    (`max_queued_requests`) or a tenant's token-bucket quota was full.
    Retryable by the client after backoff.

    ``retry_after_s`` carries the computed backoff when the shedder knows
    it (the tenant bucket's refill time); None when it does not.
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
