"""Global control store: KV, pub/sub, the named-actor registry, and the
durability that lets a head restart.

Port of `ray_tpu/core/gcs.py`: the namespaced KV store, the publish /
subscribe channels with their bounded history, the named-actor table, and
the cluster epoch that the GCS service's fence reads (`current_epoch`,
`bump_epoch`). Durability is two-layer, as in JAX:

- periodic atomic **snapshots** of the durable tables (``snapshot`` /
  ``restore``), and
- an append-only mutation **WAL** (``GcsWal``): every durable-table write
  is journaled at mutation time, so a restore replays acknowledged writes
  made *after* the newest snapshot. Snapshots compact the log.

The WAL's record framing is JAX's byte for byte (header, sha prefix,
body); the bodies and the snapshot are pickled with the standard pickle,
as everything else the port ships, so a JAX journal of plain values reads
here too. Every mutation of the durable tables (``KVStore._data``,
``GlobalControlStore._named_actors``) routes through the ``_journal``
hook; restore and replay (``WAL_EXEMPT_FUNCTIONS``) re-apply journaled
state without journaling it again.
"""

from __future__ import annotations

import fnmatch
import hashlib
import logging
import os
import pickle
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# Pub/sub channel carrying announced node preemptions: messages are
# {node_hex, reason, warning_s, deadline}. Train controllers subscribe
# (emergency checkpoint + restart); `Runtime.preempt_node` publishes for a
# logical node, `ClusterContext.begin_preemption` for a node agent, and
# every cluster member relays its peers' notices here.
PREEMPT_CHANNEL = "node_preemption"

# GCS KV namespace for head-identity state: the cluster EPOCH lives here
# as an ordinary KV value (JAX's layout, so a restored head bumps it).
HEAD_NS = "_head"
EPOCH_KEY = "epoch"

# KV namespace for registered profile captures: profile_id -> capture
# record (meta only; artifact bytes stay in the ProfileStore of the
# process that coordinated the capture; the record names them by node)
PROFILE_NS = "_profiles"

# KV namespace of the federated flight-recorder table: node_hex -> bounded
# list of that node's recent typed events, shipped on the stats piggyback
# (core/cluster.py); `state.events()` reads it back cluster-wide.
EVENT_NS = "_events"

# KV namespace of the federated request-forensics table: node_hex ->
# bounded list of that node's recent request phase marks (serve/reqlog.py),
# shipped like EVENT_NS; `state.request_timeline()` joins it with the
# local ring, so one request's marks on several nodes read as one.
REQLOG_NS = "_requests"

# KV namespace of the federated training-forensics table: node_hex ->
# bounded list of that node's recent step phase marks (train/steplog.py),
# shipped like EVENT_NS; `state.step_timeline()` joins it with the ring.
STEPLOG_NS = "_steps"

# Functions of THIS module that mutate the durable tables without
# journaling: restore and replay re-apply journaled state, constructors
# create the empty tables.
WAL_EXEMPT_FUNCTIONS = (
    "__init__",
    "restore",
    "_apply",
    "replay_wal",
)

# ---------------------------------------------------------------------- WAL
# Record framing (JAX's): fixed header + sha prefix + pickled body,
# flushed per record so a SIGKILLed head loses nothing it acknowledged.
# Readers stop at the first short or corrupt record and quarantine the
# tail bytes instead of guessing.
_REC_HDR = struct.Struct(">IQ")  # (payload_len, seq)
_SHA_BYTES = 8


def _scan_wal(path: str) -> Tuple[List[Tuple[int, str, tuple]], int, int]:
    """Scan a WAL file: (records, good_offset, total_size), where records
    are (seq, op, args) and good_offset is the byte length of the valid
    prefix; anything past it is a torn tail."""
    records: List[Tuple[int, str, tuple]] = []
    try:
        size = os.path.getsize(path)
    except OSError:
        return records, 0, 0
    good = 0
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_REC_HDR.size)
            if len(hdr) < _REC_HDR.size:
                break
            length, seq = _REC_HDR.unpack(hdr)
            sha = f.read(_SHA_BYTES)
            blob = f.read(length)
            if len(sha) < _SHA_BYTES or len(blob) < length:
                break  # torn tail: the head died mid-append
            if hashlib.sha256(blob).digest()[:_SHA_BYTES] != sha:
                break  # corrupt record: trust nothing after it
            try:
                op, args = pickle.loads(blob)
            except Exception:
                break
            records.append((seq, op, args))
            good = f.tell()
    return records, good, size


class GcsWal:
    """Append-only GCS mutation journal.

    One record per acknowledged durable-table write, appended and flushed
    BEFORE the RPC reply leaves the head, so "acknowledged" implies
    "replayable". ``fsync=True`` also survives host power loss
    (``gcs_wal_fsync``). Opening an existing journal resumes its seq
    numbering and quarantines a torn tail (the bytes past the last whole
    record move to ``<path>.quarantine``)."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self.last_seq = 0  # guarded-by: _lock
        self.records_appended = 0  # guarded-by: _lock
        self.quarantined_bytes = 0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        records, good, size = _scan_wal(path)
        if records:
            self.last_seq = records[-1][0]
        if size > good:
            self.quarantined_bytes = self._quarantine_tail(path, good)
        self._fh = open(path, "ab")  # guarded-by: _lock

    @staticmethod
    def _quarantine_tail(path: str, good: int) -> int:
        """Move the torn or corrupt suffix aside (a postmortem may want
        it) and truncate the journal to its valid prefix, so appends
        resume on a record boundary."""
        with open(path, "rb") as f:
            f.seek(good)
            tail = f.read()
        qpath = path + ".quarantine"
        with open(qpath, "ab") as q:
            q.write(tail)
        with open(path, "rb+") as f:
            f.truncate(good)
        logger.warning("gcs wal: quarantined %d torn-tail byte(s) from %s -> %s",
                       len(tail), path, qpath)
        return len(tail)

    @staticmethod
    def _encode(seq: int, op: str, args: tuple) -> bytes:
        blob = pickle.dumps((op, args), protocol=pickle.HIGHEST_PROTOCOL)
        return (_REC_HDR.pack(len(blob), seq)
                + hashlib.sha256(blob).digest()[:_SHA_BYTES] + blob)

    def append(self, op: str, args: tuple) -> int:
        """Journal one mutation; returns its seq. Raises if the args cannot
        be pickled (live handles are not durable by design)."""
        with self._lock:
            seq = self.last_seq + 1
            rec = self._encode(seq, op, args)
            self._fh.write(rec)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self.last_seq = seq
            self.records_appended += 1
            return seq

    def compact(self, cutoff_seq: int) -> int:
        """Drop the records a snapshot covers (seq <= cutoff): rewrite the
        journal atomically with only the newer ones. Returns how many
        records it kept. Holds the append lock throughout: a record
        journaled mid-rewrite would land in the file being replaced."""
        with self._lock:
            self._fh.close()
            records, _, _ = _scan_wal(self.path)
            keep = [r for r in records if r[0] > cutoff_seq]
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                for seq, op, args in keep:
                    f.write(self._encode(seq, op, args))
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")
            return len(keep)

    def stats(self) -> Dict[str, Any]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        with self._lock:
            last_seq, appended = self.last_seq, self.records_appended
        return {
            "path": self.path,
            "size_bytes": size,
            "last_seq": last_seq,
            "records_appended": appended,
            "quarantined_bytes": self.quarantined_bytes,
        }

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass


class KVStore:
    """Namespaced key-value store (reference: gcs_kv_manager.h)."""

    def __init__(self):
        self._data: Dict[Tuple[str, str], Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # installed by GlobalControlStore.attach_wal; called UNDER _lock so
        # the journal's order is the order the writes landed in
        self._journal: Optional[Callable[[str, tuple], None]] = None

    def put(self, key: str, value: Any, namespace: str = "default", overwrite: bool = True) -> bool:
        with self._lock:
            k = (namespace, key)
            if not overwrite and k in self._data:
                return False
            self._data[k] = value
            if self._journal is not None:
                self._journal("kv_put", (key, value, namespace))
            return True

    def get(self, key: str, namespace: str = "default", default: Any = None) -> Any:
        with self._lock:
            return self._data.get((namespace, key), default)

    def delete(self, key: str, namespace: str = "default") -> bool:
        with self._lock:
            existed = self._data.pop((namespace, key), None) is not None
            if existed and self._journal is not None:
                self._journal("kv_delete", (key, namespace))
            return existed

    def keys(self, pattern: str = "*", namespace: str = "default") -> List[str]:
        with self._lock:
            return [k for (ns, k) in self._data if ns == namespace and fnmatch.fnmatch(k, pattern)]


class PubSub:
    """In-process publish/subscribe with per-channel history.

    Subscribers get direct callbacks; they may also poll the bounded
    per-channel history.
    """

    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = {}  # guarded-by: _lock
        self._history: Dict[str, List[Tuple[float, Any]]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # (channel, callback) pairs that already produced one WARNING:
        # a permanently broken subscriber must be visible, not spam
        self._warned: set = set()  # guarded-by: _lock
        # telemetry: ships in the node stats snapshot (core/stats.py)
        self.stats = {"published": 0, "delivered": 0, "subscriber_errors": 0}  # guarded-by: _lock

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, ()))
            self._history.setdefault(channel, []).append((time.time(), message))
            hist = self._history[channel]
            if len(hist) > 1000:
                del hist[: len(hist) - 1000]
            self.stats["published"] += 1
        for cb in subs:
            try:
                cb(message)
                # raylint lock-discipline caught this increment racing
                # concurrent publishers outside the critical section
                with self._lock:
                    self.stats["delivered"] += 1
            except Exception as exc:  # noqa: BLE001 - subscriber bugs must not kill publishers
                # One WARNING event per (channel, callback) lifetime (the
                # metrics-sampler pattern): a dead preemption/failover
                # listener used to swallow its exceptions silently.
                key = (channel, cb)
                with self._lock:
                    first = key not in self._warned
                    self._warned.add(key)
                    self.stats["subscriber_errors"] += 1
                if first:
                    from ..util.events import emit

                    emit("WARNING", "gcs",
                         f"pubsub subscriber on channel {channel!r} raised; "
                         f"further failures suppressed: {exc!r}",
                         kind="gcs.subscriber_error",
                         channel=channel, callback=repr(cb))
                logger.warning("pubsub subscriber on %r failed: %r", channel, exc)

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        with self._lock:
            self._subs.setdefault(channel, []).append(callback)

    def unsubscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        with self._lock:
            cbs = self._subs.get(channel, [])
            if callback in cbs:
                cbs.remove(callback)

    def poll(self, channel: str, since: float = 0.0) -> List[Tuple[float, Any]]:
        with self._lock:
            return [m for m in self._history.get(channel, ()) if m[0] > since]


class GlobalControlStore:
    """Composite control plane: KV + pubsub + named-actor registry, with
    the snapshot and the WAL that make it restartable."""

    def __init__(self):
        self.kv = KVStore()
        self.pubsub = PubSub()
        self._named_actors: Dict[Tuple[str, str], Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._wal: Optional[GcsWal] = None
        # keys whose values could not be pickled into the snapshot / the
        # WAL: live handles are not durable, said ONCE per key
        self._snap_warned: set = set()
        self._wal_warned: set = set()
        self.last_restore: Dict[str, Any] = {}
        self.last_snapshot_ts: float = 0.0

    # --------------------------------------------------------------- WAL
    def attach_wal(self, path: str, fsync: bool = False) -> GcsWal:
        """Journal every durable-table mutation to `path` from now on.
        Mutations made BEFORE are only as durable as the next snapshot:
        attach at init, before serving."""
        wal = GcsWal(path, fsync=fsync)
        self._wal = wal
        self.kv._journal = self._journal
        return wal

    def _journal(self, op: str, args: tuple) -> None:
        """The one WAL write path. An unpicklable value is skipped with a
        warning once per key, as in the snapshot."""
        wal = self._wal
        if wal is None:
            return
        try:
            wal.append(op, args)
        except Exception as exc:
            key = (op, args[0] if args else None)
            if key not in self._wal_warned:
                self._wal_warned.add(key)
                logger.warning(
                    "gcs wal: cannot journal %s %r (value not picklable; "
                    "further failures for this key suppressed): %r",
                    op, key[1], exc)

    def detach_wal(self) -> None:
        """Stop journaling and close the journal (the shutdown path)."""
        wal, self._wal = self._wal, None
        self.kv._journal = None
        if wal is not None:
            wal.close()

    def wal_stats(self) -> Optional[Dict[str, Any]]:
        wal = self._wal
        return wal.stats() if wal is not None else None

    # ------------------------------------------------------------- epoch
    def current_epoch(self) -> int:
        """The cluster epoch: bumped on every head restore so writes from
        before the restart are fenceable (`gcs_service._fence`)."""
        return int(self.kv.get(EPOCH_KEY, namespace=HEAD_NS, default=0))

    def bump_epoch(self) -> int:
        """Advance the epoch (journaled like any KV write). The runtime
        calls it once after a restore, before the RPC server opens."""
        epoch = self.current_epoch() + 1
        self.kv.put(EPOCH_KEY, epoch, namespace=HEAD_NS)
        return epoch

    def register_named_actor(self, name: str, handle: Any, namespace: str = "default") -> None:
        with self._lock:
            key = (namespace, name)
            # a None entry is a restored placeholder (the name existed
            # before a restart; the actor is gone): it must be reclaimable
            if self._named_actors.get(key) is not None:
                raise ValueError(f"Actor name {name!r} already taken in namespace {namespace!r}")
            self._named_actors[key] = handle
            # journal the NAME only: the restored entry is a placeholder
            self._journal("actor_register", (name, namespace))
        self.pubsub.publish("actors", {"event": "registered", "name": name})

    def get_named_actor(self, name: str, namespace: str = "default") -> Optional[Any]:
        with self._lock:
            return self._named_actors.get((namespace, name))

    def unregister_named_actor(self, name: str, namespace: str = "default") -> None:
        with self._lock:
            existed = self._named_actors.pop((namespace, name), None) is not None
            if existed:
                self._journal("actor_unregister", (name, namespace))

    def list_named_actors(self, namespace: str = "default") -> List[str]:
        with self._lock:
            return [n for (ns, n) in self._named_actors if ns == namespace]

    # ------------------------------------------------------- persistence
    # One atomic pickle snapshot of the durable tables (KV + the named-
    # actor registry + the runtime's `extra`), written periodically and
    # restored at init; the WAL covers the gap since the newest snapshot.
    # Live handles are not durable: names are kept, so a restarted head
    # knows what existed; the actors themselves must be re-created.

    def snapshot(self, path: str, extra: Optional[Dict[str, Any]] = None) -> None:
        # copy the table under the lock, pickle OUTSIDE it (kv_put rides
        # every heartbeat). The WAL cutoff is read under the same hold:
        # journaling happens under kv._lock too, so every record with
        # seq <= wal_seq is already in `items`.
        with self.kv._lock:
            items = list(self.kv._data.items())
            wal_seq = self._wal.last_seq if self._wal is not None else -1
        kv_items = []
        for k, v in items:
            try:
                blob = pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:
                if k not in self._snap_warned:
                    self._snap_warned.add(k)
                    logger.warning(
                        "gcs snapshot: skipping unpicklable key %r "
                        "(further snapshots suppress this warning)", k)
                continue
            kv_items.append((k, blob))
        with self._lock:
            actor_names = list(self._named_actors.keys())
        payload = {
            "kv": kv_items,
            "named_actors": actor_names,
            "extra": extra or {},
            "ts": time.time(),
            "wal_seq": wal_seq,
            "epoch": self.current_epoch(),
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic: a crash never leaves a torn snapshot
        self.last_snapshot_ts = time.time()
        if self._wal is not None:
            self._wal.compact(wal_seq)  # records <= wal_seq are in the snapshot

    def restore(self, path: str, wal_path: Optional[str] = None) -> Dict[str, Any]:
        """Load a snapshot into this store, then replay the WAL records
        newer than its cutoff; returns the `extra` payload. Restored named
        actors map to None (the actor process is gone), so a lookup tells
        'never existed' from 'existed before the restart'."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        decoded = []
        for k, blob in payload["kv"]:
            try:
                decoded.append((k, pickle.loads(blob)))
            except Exception:
                logger.warning("gcs restore: skipping undecodable key %r", k)
        with self.kv._lock:
            for k, value in decoded:
                self.kv._data[k] = value
        with self._lock:
            for key in payload["named_actors"]:
                self._named_actors.setdefault(tuple(key), None)
        self.last_restore = {
            "snapshot_ts": payload.get("ts", 0.0),
            "snapshot_wal_seq": payload.get("wal_seq", -1),
            "wal_records_applied": 0,
            "wal_quarantined_bytes": 0,
        }
        if wal_path and os.path.exists(wal_path):
            self.replay_wal(wal_path, payload.get("wal_seq", -1))
        return payload.get("extra", {})

    def replay_wal(self, wal_path: str, cutoff_seq: int) -> int:
        """Apply the journal's records newer than the snapshot's cutoff, in
        order. Replay is idempotent (puts overwrite, deletes tolerate
        absence, actor names setdefault). Returns the number applied."""
        records, good, size = _scan_wal(wal_path)
        applied = 0
        for seq, op, args in records:
            if seq <= cutoff_seq:
                continue
            self._apply(op, args)
            applied += 1
        self.last_restore["wal_records_applied"] = applied
        self.last_restore["wal_quarantined_bytes"] = max(0, size - good)
        if applied or size > good:
            logger.info("gcs restore: replayed %d WAL record(s) past snapshot cutoff %d "
                        "(%d torn-tail byte(s) ignored)", applied, cutoff_seq,
                        max(0, size - good))
        return applied

    def _apply(self, op: str, args: tuple) -> None:
        """Apply one journal record WITHOUT journaling it again."""
        if op == "kv_put":
            key, value, namespace = args
            with self.kv._lock:
                self.kv._data[(namespace, key)] = value
        elif op == "kv_delete":
            key, namespace = args
            with self.kv._lock:
                self.kv._data.pop((namespace, key), None)
        elif op == "actor_register":
            name, namespace = args
            with self._lock:
                self._named_actors.setdefault((namespace, name), None)
        elif op == "actor_unregister":
            name, namespace = args
            with self._lock:
                self._named_actors.pop((namespace, name), None)
        else:
            logger.warning("gcs wal: unknown op %r ignored", op)
