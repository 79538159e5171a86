"""In-process log capture: a ring buffer of this process's log lines.

Port of `ray_tpu/util/logs.py`: one process per node means one logging
stream per node; a ring-buffer Handler captures the tail, the node agent
serves it over its RPC server (`node_logs`), and `cluster_tail`
aggregates the tails over the cluster. Every captured line carries its
origin: a [node:...] prefix (set once per process) and, inside a
task/actor execution path, the [task:...]/[actor:...] tag of the
context-local attribution. Nothing is written to disk unless the user
configures logging to do so."""

from __future__ import annotations

import contextlib
import contextvars
import logging
import threading
from collections import deque
from typing import Dict, Iterator, List, Optional

# -------------------------------------------------------------- attribution
#
# Captured lines carry their ORIGIN: a [node:...] prefix (set once per
# process) and, when the record was emitted from inside a task/actor
# execution path, a [task:...]/[actor:...] tag from the context-local
# attribution — so merged tails can still be grouped by origin.

_node_hex: Optional[str] = None
_log_ctx: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "ray_tpu_torch_log_attribution", default=None
)


def set_node_id(node_hex: str) -> None:
    """Record this process's node id; captured lines get a
    [node:<prefix>] tag from here on (idempotent, runtime init calls it)."""
    global _node_hex
    _node_hex = node_hex


@contextlib.contextmanager
def attribution(tag: str) -> Iterator[None]:
    """Tag log records emitted inside the block with their originating
    task/actor (e.g. "task:ab12cd34", "actor:Trainer"). Set by the
    executing thread, so it composes with the reused task threads."""
    token = _log_ctx.set(tag)
    try:
        yield
    finally:
        _log_ctx.reset(token)


class RingBufferHandler(logging.Handler):
    """Keeps the last N formatted log lines in memory, each prefixed
    with its origin ([node:...] and the active task/actor attribution)."""

    def __init__(self, capacity: int = 5000):
        super().__init__()
        self._buf: "deque[str]" = deque(maxlen=capacity)
        self._lock2 = threading.Lock()
        self.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"
        ))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
            prefix = ""
            if _node_hex:
                prefix += f"[node:{_node_hex[:8]}] "
            ctx = _log_ctx.get()
            if ctx:
                prefix += f"[{ctx}] "
            line = prefix + line
        except Exception:  # noqa: BLE001 - logging must never raise
            return
        with self._lock2:
            self._buf.append(line)

    def tail(self, n: int = 200) -> List[str]:
        with self._lock2:
            return list(self._buf)[-n:]


_handler: Optional[RingBufferHandler] = None
_install_lock = threading.Lock()


def install(capacity: int = 5000) -> RingBufferHandler:
    """Attach the capture handler (idempotent). It hangs off the root
    logger, and the "ray_tpu_torch" logger's level is raised to INFO if
    unset, since the root default of WARNING would filter the package's
    INFO records at the LOGGER before any handler ran; everyone else's
    WARNING+ is captured too. User console verbosity is untouched:
    the stdlib lastResort console handler still gates at WARNING."""
    global _handler
    with _install_lock:
        if _handler is None:
            _handler = RingBufferHandler(capacity)
            _handler.setLevel(logging.INFO)
            # Logger levels gate at the EMITTING logger; propagation then
            # reaches ancestor HANDLERS unconditionally — so raising the
            # package logger to INFO + one handler on root captures
            # ray_tpu_torch INFO and everyone's WARNING+ exactly once.
            pkg = logging.getLogger("ray_tpu_torch")
            if pkg.level == logging.NOTSET:
                pkg.setLevel(logging.INFO)
            logging.getLogger().addHandler(_handler)
        return _handler


def tail(n: int = 200) -> List[str]:
    """Last n captured lines of THIS process."""
    return _handler.tail(n) if _handler is not None else []


def cluster_tail(runtime, n: int = 200) -> Dict[str, List[str]]:
    """Log tails for every cluster node, keyed by node id hex: this
    process's buffer plus each agent's over the node_logs RPC (an agent
    that does not answer names itself in a placeholder line)."""
    ctx = getattr(runtime, "cluster", None)
    if ctx is None:
        return {"local": tail(n)}
    out = ctx.fanout_nodes("node_logs", n, placeholder=lambda e: [f"<unreachable: {e!r}>"])
    out[ctx.node_id.hex()] = tail(n)
    return out
