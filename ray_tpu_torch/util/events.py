"""Flight recorder: typed, durable, queryable runtime events.

Port of `ray_tpu/util/events.py`: every process keeps an in-memory ring
PLUS an optional JSONL sink and an optional bounded on-disk segment log
(`configure_segments`, replayed by `read_segments`). The federation of
each node's tail into the control plane's `_events` table comes with
ROADMAP A6b (federation); `since` is its cursor walk.

Events are TYPED: every emit names a ``kind`` registered in
``EVENT_KINDS`` (the same catalog as the JAX package's, so the two
packages' event streams read alike), and components may register more
with ``register_event_kind``.

Each event records BOTH clocks: ``ts`` (wall, for cross-node timeline
placement) and ``mono`` (monotonic, for intra-process interval math
that must not jump with NTP).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")

# Common spellings normalized into the fixed set; anything else is an
# unknown level and degrades to INFO (events must never raise).
_SEVERITY_ALIASES = {
    "WARN": "WARNING",
    "ERR": "ERROR",
    "FATAL": "ERROR",
    "CRITICAL": "ERROR",
    "TRACE": "DEBUG",
}


def normalize_severity(severity: Any) -> str:
    s = str(severity).strip().upper()
    s = _SEVERITY_ALIASES.get(s, s)
    return s if s in SEVERITIES else "INFO"


# ------------------------------------------------------------ kind registry
#
# kind -> one-line doc. The catalog is seeded from every emitting
# subsystem of the JAX package; components may register additional
# kinds at import time with register_event_kind.

EVENT_KINDS: Dict[str, str] = {
    # node lifecycle
    "node.discovered": "a cluster node joined or rejoined the view",
    "node.dead": "a node aged out of heartbeats or was removed",
    "node.preempt_expired": "a preempted node's warning window closed",
    # preemption announce/drain
    "preempt.announced": "a node announced its upcoming preemption",
    "preempt.drain": "a PREEMPTING node stopped taking new placements",
    "preempt.notice": "a train controller received a preemption notice",
    # placement-group FSM
    "pg.transition": "a placement group moved between FSM states",
    "pg.reschedule_failed": "one placement-group reschedule attempt failed",
    # tasks / actors
    "actor.restart": "an actor restarted onto a (re-reserved) bundle/node",
    "task.parked": "an agent parked an undeliverable task completion",
    # checkpoints
    "ckpt.saved": "a training checkpoint committed (incl. emergency saves)",
    "ckpt.quarantine": "a corrupt/torn checkpoint was quarantined",
    "ckpt.fallback": "a restore fell back past a quarantined checkpoint",
    "ckpt.gc": "an uncommitted/torn checkpoint dir was garbage-collected",
    # train run lifecycle
    "train.gang_started": "a training gang (re)started and is running",
    "train.finished": "a training run finished cleanly",
    "train.errored": "a training run errored out",
    "train.restart": "a training gang restarted after a failure",
    "train.preempt_restart": "a gang restarted after an announced preemption",
    "train.coordinator": "a multihost gang elected its coordinator",
    # serve lifecycle
    "serve.deploy": "a serve deployment was (re)deployed",
    "serve.scaled": "a deployment scaled its replica count",
    "serve.drain": "a serve replica began draining",
    "serve.autoscale": "the serve autoscaler changed a replica target",
    "serve.shed": "admission control shed a request (quota/backlog)",
    "serve.degraded": "the serve controller froze/resumed over a head outage",
    "serve.lane_preempted": "a low-priority decode lane was parked for pages",
    "serve.lane_resumed": "a parked decode lane re-admitted after pressure",
    # streaming data plane
    "data.stage_start": "a streaming dataset stage began submitting tasks",
    "data.stage_finish": "a streaming dataset stage drained its last block",
    "data.backpressure": "the data executor stalled on its byte budget",
    "data.spill": "a data-plane run pushed blocks through the spill path",
    "data.reexec": "a lost block was re-executed via lineage mid-ingest",
    # chaos
    "chaos.injected": "a chaos injection fired (delay/failure/kill/preempt)",
    # watchdogs
    "watchdog.stall": "the training stall watchdog flagged a stall",
    "watchdog.recovered": "a stalled run recovered",
    "watchdog.slo_burn": "a serve SLO window exceeded its objective",
    # control plane
    "gcs.restored": "the GCS restored its tables from a snapshot",
    "gcs.subscriber_error": "a pubsub subscriber raised (first failure)",
    # head fault tolerance
    "head.unreachable": "the GCS head stopped answering; degraded mode began",
    "head.reconnected": "the GCS head answered again after an outage",
    "head.stale_epoch": "a write was fenced for carrying a pre-restart epoch",
    "head.reconciled": "a restored head finished reconciling restored state",
    "node.purged": "a restored node never re-announced and was purged",
    "health.dead": "the health-check manager declared a target dead",
    "health.oom": "the OOM policy killed a worker",
    "metrics.sampler_error": "a gauge callback raised (first failure)",
    "autoscaler.scaled": "the autoscaler launched or released a node",
    # capacity plane (core/capacity.py)
    "autoscaler.scale_up": "the capacity plane launched node(s) for pending demand",
    "autoscaler.scale_down": "the capacity plane retired a node through the drain path",
    "autoscaler.replace": "replacement capacity pre-provisioned for a preempting node",
    "autoscaler.blocked": "pending demand cannot be provisioned (limits/budget)",
    "autoscaler.error": "the autoscaler loop raised (first per exception type)",
}


def register_event_kind(kind: str, doc: str = "") -> None:
    """Register an additional typed event kind (idempotent)."""
    EVENT_KINDS.setdefault(kind, doc)


def event_kinds() -> Dict[str, str]:
    """The registered kind catalog (copy)."""
    return dict(EVENT_KINDS)


def _default_node() -> Optional[str]:
    """Attribute events to this process's node (util/logs sets it at
    runtime init) unless the emitter names a more specific one."""
    from . import logs

    return logs._node_hex


class EventLog:
    """Per-process event recorder: ring buffer + optional JSONL sink +
    optional bounded durable segment directory."""

    def __init__(self, capacity: int = 10_000,
                 sink_path: Optional[str] = None):
        self._buf: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._sink_path = sink_path
        self._sink_file = None  # cached handle: no per-event open()
        self._seq = 0
        # durable bounded segments (flight-recorder disk arm)
        self._seg_dir: Optional[str] = None
        self._seg_file = None
        self._seg_bytes = 0
        self._seg_max_bytes = 1 << 20
        self._seg_keep = 8
        self._seg_counter = 0

    def _sink_handle(self):
        """Caller holds the lock. Lazily (re)open the cached JSONL
        handle — event-heavy failover drills must not pay an open() per
        event; set_sink swaps it."""
        if self._sink_file is None and self._sink_path:
            self._sink_file = open(self._sink_path, "a")
        return self._sink_file

    def emit(self, severity: str, source: str, message: str,
             kind: str = "", node: Optional[str] = None,
             **extra: Any) -> Dict[str, Any]:
        """Record one typed event. `source` is the emitting subsystem
        ("cluster", "train", "health", ...); `kind` is a registered
        EVENT_KINDS name (unknown kinds are still recorded);
        `node` attributes the event to a node id hex (defaults to this
        process's node)."""
        severity = normalize_severity(severity)
        if node is None:
            node = _default_node()
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "ts": time.time(),
                "mono": time.monotonic(),
                "severity": severity,
                "kind": kind or "",
                "source": source,
                "node": node,
                "message": message,
                **({"extra": extra} if extra else {}),
            }
            self._buf.append(event)
            # write under the lock: concurrent emitters on one handle
            # would otherwise interleave partial JSONL lines
            line = None
            try:
                f = self._sink_handle()
                if f is not None:
                    line = json.dumps(event, default=str)
                    f.write(line + "\n")
                    f.flush()
            except (OSError, ValueError, TypeError):
                # a full disk must not take the runtime down; drop the
                # handle so a later emit can retry a fresh open
                self._close_sink_locked()
            try:
                self._segment_write_locked(
                    line if line is not None
                    else json.dumps(event, default=str)
                )
            except (OSError, ValueError, TypeError):
                self._close_segment_locked()
        return event

    def _close_sink_locked(self) -> None:
        if self._sink_file is not None:
            try:
                self._sink_file.close()
            except OSError:
                pass
            self._sink_file = None

    # ------------------------------------------------------ durable segments

    def configure_segments(self, directory: Optional[str],
                           max_bytes: Optional[int] = None,
                           keep: Optional[int] = None) -> None:
        """Enable (or disable, with None) the bounded on-disk segment
        log: events append to `<dir>/events.jsonl`; once it exceeds
        `max_bytes` it rotates — an atomic os.replace into a numbered
        segment file — and only the newest `keep` rotated segments
        survive. Readers tolerate a torn tail line (a crash mid-append
        loses at most the event being written)."""
        from ..core.config import cfg

        with self._lock:
            self._close_segment_locked()
            self._seg_dir = directory or None
            self._seg_max_bytes = (
                cfg.events_segment_bytes if max_bytes is None else max_bytes
            )
            self._seg_keep = cfg.events_segments_keep if keep is None else keep
            if self._seg_dir:
                os.makedirs(self._seg_dir, exist_ok=True)
                # resume the rotation counter past existing segments
                self._seg_counter = max(
                    [_segment_index(n) for n in os.listdir(self._seg_dir)
                     if _segment_index(n) is not None] or [0]
                )

    def _segment_write_locked(self, line: str) -> None:
        if not self._seg_dir:
            return
        if self._seg_file is None:
            path = os.path.join(self._seg_dir, "events.jsonl")
            self._seg_file = open(path, "a")
            self._seg_bytes = self._seg_file.tell()
        self._seg_file.write(line + "\n")
        self._seg_file.flush()
        self._seg_bytes += len(line) + 1
        if self._seg_bytes >= self._seg_max_bytes:
            self._rotate_segment_locked()

    def _rotate_segment_locked(self) -> None:
        self._seg_file.close()
        self._seg_file = None
        self._seg_bytes = 0
        self._seg_counter += 1
        current = os.path.join(self._seg_dir, "events.jsonl")
        rotated = os.path.join(
            self._seg_dir, f"events-{self._seg_counter:06d}.jsonl"
        )
        os.replace(current, rotated)  # atomic: no torn half-renamed state
        # prune beyond the retention bound, oldest first
        segments = sorted(
            n for n in os.listdir(self._seg_dir)
            if _segment_index(n) is not None
        )
        for name in segments[: max(0, len(segments) - self._seg_keep)]:
            try:
                os.remove(os.path.join(self._seg_dir, name))
            except OSError:
                pass

    def _close_segment_locked(self) -> None:
        if self._seg_file is not None:
            try:
                self._seg_file.close()
            except OSError:
                pass
            self._seg_file = None
            self._seg_bytes = 0

    # --------------------------------------------------------------- queries

    def list(self, *, since_seq: int = 0, severity: Optional[str] = None,
             source: Optional[str] = None, kind: Optional[str] = None,
             node: Optional[str] = None, since_ts: float = 0.0,
             limit: int = 1000) -> List[Dict[str, Any]]:
        """Filtered event tail (oldest first). `severity` matching is
        case-insensitive; `node` matches on hex prefix."""
        sev = normalize_severity(severity) if severity is not None else None
        with self._lock:
            out = [
                e for e in self._buf
                if e["seq"] > since_seq
                and e["ts"] >= since_ts
                and (sev is None or e["severity"] == sev)
                and (source is None or e["source"] == source)
                and (kind is None or e.get("kind") == kind)
                and (node is None or str(e.get("node") or "").startswith(node))
            ]
        return out[-limit:]

    def since(self, seq: int, max_n: int = 1000) -> List[Dict[str, Any]]:
        """The OLDEST max_n events with seq greater than `seq` — the
        federation cursor walk (never skips events the way a tail-limit
        would; a slow shipper just takes more periods to catch up)."""
        with self._lock:
            return [e for e in self._buf if e["seq"] > seq][:max_n]

    def stats(self) -> Dict[str, Any]:
        """Flight-recorder health: total events emitted, ring occupancy,
        and whether the durable segment arm is on."""
        with self._lock:
            return {
                "seq": self._seq,
                "buffered": len(self._buf),
                "segments_dir": self._seg_dir,
            }

    def set_sink(self, path: Optional[str]) -> None:
        with self._lock:
            self._close_sink_locked()
            self._sink_path = path
            if path:
                try:
                    self._sink_file = open(path, "a")
                except OSError:
                    self._sink_file = None  # emit retries lazily

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


def _segment_index(name: str) -> Optional[int]:
    """events-000042.jsonl -> 42; anything else -> None."""
    if not (name.startswith("events-") and name.endswith(".jsonl")):
        return None
    stem = name[len("events-"):-len(".jsonl")]
    return int(stem) if stem.isdigit() else None


def read_segments(directory: str) -> List[Dict[str, Any]]:
    """Replay a segment directory oldest-first: rotated segments in
    order, then the live file. Undecodable lines (torn tail after a
    crash) are skipped, not raised."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(
            n for n in os.listdir(directory) if _segment_index(n) is not None
        )
    except OSError:
        return out
    names.append("events.jsonl")
    for name in names:
        try:
            with open(os.path.join(directory, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue  # torn tail line
        except OSError:
            continue
    return out


_log: Optional[EventLog] = None
_log_lock = threading.Lock()


def events() -> EventLog:
    global _log
    with _log_lock:
        if _log is None:
            _log = EventLog()
        return _log


def emit(severity: str, source: str, message: str, kind: str = "",
         node: Optional[str] = None, **extra: Any) -> None:
    """Module-level convenience used by runtime components."""
    events().emit(severity, source, message, kind=kind, node=node, **extra)
