"""Per-request serve context: the end-to-end deadline, id, tenant and
priority of the request executing on this thread.

Port of `ray_tpu/serve/context.py`. The values live on `contextvars`, so
`LLMServer._submit` reads the same ambient values in both packages (a
replica wrapper sets them around each call; the port has no router yet,
so a caller sets them with the `_set_*` functions). Engines treat a
missing tenant as "default"; priority gates lane preemption and orders
the admit queue's tiers.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional, Tuple

_deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "raytpu_serve_deadline", default=None
)


def get_request_deadline() -> Optional[float]:
    """Absolute deadline (time.time() epoch seconds) of the serve request
    currently executing on this thread, or None when no deadline is set."""
    return _deadline.get()


def remaining_s() -> Optional[float]:
    """Seconds left before the ambient deadline (None = no deadline;
    never negative)."""
    deadline = _deadline.get()
    if deadline is None:
        return None
    return max(0.0, deadline - time.time())


def _set_request_deadline(deadline_ts: Optional[float]):
    """Installs the deadline for the executing request; returns the reset
    token."""
    return _deadline.set(deadline_ts)


def _reset_request_deadline(token) -> None:
    _deadline.reset(token)


_tenant: contextvars.ContextVar[Optional[Tuple[Optional[str], Optional[int]]]] = (
    contextvars.ContextVar("raytpu_serve_tenant", default=None)
)


def get_request_tenant() -> Optional[str]:
    """Tenant id of the executing serve request, or None when it carries
    none."""
    pair = _tenant.get()
    return pair[0] if pair is not None else None


def get_request_priority() -> Optional[int]:
    """Priority of the executing serve request (higher = more important),
    or None when unset."""
    pair = _tenant.get()
    return pair[1] if pair is not None else None


def _set_request_tenant(tenant: Optional[str], priority: Optional[int]):
    """Installs the tenant/priority pair for the executing request;
    returns the reset token."""
    return _tenant.set((tenant, priority))


def _reset_request_tenant(token) -> None:
    _tenant.reset(token)


_request_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "raytpu_serve_request_id", default=None
)


def get_request_id() -> Optional[str]:
    """End-to-end id of the executing serve request, or None."""
    return _request_id.get()


def _set_request_id(request_id: Optional[str]):
    """Installs the request id for the executing request; returns the
    reset token."""
    return _request_id.set(request_id)


def _reset_request_id(token) -> None:
    _request_id.reset(token)
