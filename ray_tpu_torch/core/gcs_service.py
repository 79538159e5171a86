"""GCS as a service: the control plane over RPC for multi-process jobs.

Port of `ray_tpu/core/gcs_service.py`. One process (the head) serves its
GlobalControlStore; node agents and other drivers connect with GcsClient
and share the KV namespace, the pub/sub channels and the named-actor
NAME registry. Live actor handles cannot cross process boundaries, so a
remote lookup returns existence.

- **Degraded mode**: every GcsClient call retries transport errors with
  jittered backoff inside a bounded window (``gcs_client_retry_s``)
  before raising the typed ``HeadUnavailableError`` (a ConnectionError,
  so ``except (RpcError, OSError)`` sites keep working). The first
  failure and the recovery each emit ONE event (`head.unreachable` /
  `head.reconnected`) and fire the registered outage listeners.
- **Epoch fencing**: write handlers accept an ``_epoch`` kwarg; a writer
  carrying an epoch older than the head's gets a ``StaleEpochError``
  (never retried). A live client re-adopts the head's epoch and retries
  once; a pinned (zombie) writer stays rejected.
- **Function export is by reference**: JAX exports a function by value
  with cloudpickle; the port has no cloudpickle, so `register_function`
  pickles it by reference with the standard pickle and refuses one that
  a peer could not import (`worker_pool.check_importable`: a lambda, a
  nested function, `__main__`) with TypeError.
- **Durability health**: `head_info` reports the epoch, the WAL's
  stats, the last snapshot's time and the last restore's counts
  (`core/gcs.py`), which `state.head_summary()` surfaces.
"""

from __future__ import annotations

import pickle
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .exceptions import HeadUnavailableError, StaleEpochError
from .gcs import GlobalControlStore
from .rpc import RpcAuthError, RpcClient, RpcError, RpcServer

FUNC_NS = "_funcs"  # GCS KV namespace of exported functions
PG_NS = "_pgs"  # GCS KV namespace: pg id hex -> the owner's record of its state


class _ResourceSync:
    """Periodic resource-usage broadcast, aggregated at the head. Peers
    report {resource: available}; views older than `stale_s` drop out of
    the cluster aggregate, which doubles as liveness."""

    def __init__(self, stale_s: float = 10.0):
        self._views: dict = {}  # node_id -> (monotonic_ts, resources)
        self._quiet_until: dict = {}  # node_id -> monotonic deadline
        self.stale_s = stale_s

    def report(self, node_id: str, resources: dict, quiet_s: float = 0.0) -> None:
        """`quiet_s` > 0 (beyond JAX): the node may not report again for
        that long (a profile capture holds its process), and its view
        stays live until then; a report without it ends the window."""
        # monotonic: wall-clock steps (NTP) must not flip liveness
        now = time.monotonic()
        self._views[node_id] = (now, dict(resources))
        if quiet_s > 0:
            self._quiet_until[node_id] = now + float(quiet_s)
        else:
            self._quiet_until.pop(node_id, None)

    def cluster_view(self) -> dict:
        now = time.monotonic()
        total: dict = {}
        nodes = {}
        for node_id, (ts, res) in list(self._views.items()):
            if now - ts > self.stale_s and now > self._quiet_until.get(node_id, 0.0):
                # evict: under node-id churn the dead set would otherwise
                # grow (and be rescanned) forever
                self._views.pop(node_id, None)
                self._quiet_until.pop(node_id, None)
                continue
            nodes[node_id] = {"age_s": round(now - ts, 3), "resources": res}
            for k, v in res.items():
                total[k] = total.get(k, 0.0) + v
        return {"total": total, "nodes": nodes}


def _fence(gcs: GlobalControlStore, op: str, fn: Callable) -> Callable:
    """Wrap a mutating handler with the epoch fence: a caller that
    declares an epoch older than the head's current one is a zombie from
    before a restart and must not drive state. Callers that send no
    ``_epoch`` pass unfenced — the fence protects against SPLIT-BRAIN
    writers, not casual reads."""

    def wrapper(*args, _epoch: Optional[int] = None, **kwargs):
        if _epoch is not None:
            head_epoch = gcs.current_epoch()
            if int(_epoch) < head_epoch:
                raise StaleEpochError(
                    f"gcs {op} fenced: writer epoch {_epoch} < head epoch "
                    f"{head_epoch} (head restarted; re-adopt or stand down)",
                    writer_epoch=int(_epoch), head_epoch=head_epoch)
        return fn(*args, **kwargs)

    return wrapper


def serve_gcs(gcs: GlobalControlStore, host: str = "127.0.0.1", port: int = 0,
              token: Optional[str] = None,
              stale_s: float = 10.0) -> RpcServer:
    """Expose a GlobalControlStore; returns the RpcServer ('host:port' in
    .url — hand that to GcsClient in other processes)."""
    syncer = _ResourceSync(stale_s=stale_s)
    started = time.time()

    def head_info() -> Dict[str, Any]:
        """Head identity + durability health: the epoch agents adopt, the
        WAL's size and seq, the snapshot's age, the last restore."""
        return {
            "epoch": gcs.current_epoch(),
            "wal": gcs.wal_stats(),
            "last_snapshot_ts": gcs.last_snapshot_ts,
            "restore": dict(gcs.last_restore),
            "started_ts": started,
            "ts": time.time(),
        }

    handlers = {
        "ping": lambda: "ok",
        "kv_put": _fence(gcs, "kv_put", gcs.kv.put),
        "kv_get": gcs.kv.get,
        "kv_delete": _fence(gcs, "kv_delete", gcs.kv.delete),
        "kv_keys": gcs.kv.keys,
        "publish": _fence(gcs, "publish", gcs.pubsub.publish),
        "poll": gcs.pubsub.poll,
        "list_named_actors": gcs.list_named_actors,
        "has_named_actor": lambda name, namespace="default": (
            gcs.get_named_actor(name, namespace) is not None
        ),
        "report_resources": _fence(gcs, "report_resources", syncer.report),
        "cluster_view": syncer.cluster_view,
        "head_info": head_info,
    }
    server = RpcServer(handlers, host=host, port=port, token=token)
    server.syncer = syncer
    return server


class GcsClient:
    """Typed accessor over the wire; the surface mirrors the in-process
    KVStore / PubSub shapes so code can take either.

    Degraded-mode contract: transport failures retry with jittered
    backoff inside a bounded window, then raise HeadUnavailableError.
    The first failure and the eventual recovery each emit ONE event and
    fire the registered outage listeners."""

    def __init__(self, address: str, *, timeout: float = 30.0,
                 token: Optional[str] = None,
                 retry_window_s: Optional[float] = None):
        self._rpc = RpcClient(address, timeout=timeout, token=token)
        self.address = address
        # None = read gcs_client_retry_s per call (tests tune it live)
        self._retry_window_s = retry_window_s
        self._epoch: Optional[int] = None  # adopted from head_info
        self._pinned_epoch: Optional[int] = None  # test/zombie override
        self._outage_lock = threading.Lock()
        self._outage_since: Optional[float] = None  # monotonic  # guarded-by: _outage_lock
        self._listeners: List[Callable[[str, float], None]] = []  # guarded-by: _outage_lock

    # ------------------------------------------------------ degraded mode

    def on_head_state(self, listener: Callable[[str, float], None]) -> None:
        """Register listener(state, outage_s) fired once per transition:
        state is 'unreachable' (outage_s=0.0) or 'reconnected'."""
        with self._outage_lock:
            self._listeners.append(listener)

    def outage_s(self) -> float:
        """Seconds the head has currently been unreachable (0 = up)."""
        with self._outage_lock:
            since = self._outage_since
        return 0.0 if since is None else time.monotonic() - since

    def _notify(self, state: str, outage: float) -> None:
        with self._outage_lock:
            listeners = list(self._listeners)
        for cb in listeners:
            try:
                cb(state, outage)
            except Exception:  # noqa: BLE001 - listeners must not break calls
                pass

    def _note_failure(self) -> None:
        with self._outage_lock:
            first = self._outage_since is None
            if first:
                self._outage_since = time.monotonic()
        if first:
            from ..util.events import emit

            emit("WARNING", "gcs",
                 f"GCS head {self.address} unreachable: entering degraded mode",
                 kind="head.unreachable", address=self.address)
            self._notify("unreachable", 0.0)

    def _note_success(self) -> None:
        with self._outage_lock:
            since = self._outage_since
            self._outage_since = None
        if since is not None:
            outage = time.monotonic() - since
            from ..util.events import emit

            emit("INFO", "gcs",
                 f"GCS head {self.address} reconnected after {outage:.2f}s outage",
                 kind="head.reconnected", address=self.address,
                 outage_s=round(outage, 3))
            self._notify("reconnected", outage)

    def _call(self, method: str, *args, **kwargs) -> Any:
        """One RPC under the degraded-mode retry policy. Handler
        exceptions (StaleEpochError included) pass straight through —
        only transport faults retry."""
        from .config import cfg

        window = (self._retry_window_s if self._retry_window_s is not None
                  else float(cfg.gcs_client_retry_s))
        base = float(cfg.gcs_client_backoff_s)
        deadline = time.monotonic() + window
        attempt = 0
        while True:
            try:
                value = self._rpc.call(method, *args, **kwargs)
            except RpcAuthError:
                raise  # wrong token: the head is up, retrying cannot help
            except (RpcError, OSError) as exc:
                self._note_failure()
                if time.monotonic() >= deadline:
                    raise HeadUnavailableError(
                        f"GCS head {self.address} unreachable for "
                        f"{self.outage_s():.2f}s (rpc {method!r}: {exc!r})",
                        outage_s=self.outage_s()) from exc
                wait = min(1.0, base * (2 ** min(attempt, 6)))
                time.sleep(wait * (0.5 + random.random()))
                attempt += 1
                continue
            self._note_success()
            return value

    # --------------------------------------------------------------- epoch

    def head_info(self) -> Dict[str, Any]:
        """Head identity + durability health (epoch, WAL, snapshot age)."""
        return self._call("head_info")

    def adopt_epoch(self) -> int:
        """Fetch and carry the head's current epoch on every subsequent
        write; done at registration and after any StaleEpochError."""
        self._epoch = int(self.head_info().get("epoch", 0))
        return self._epoch

    @property
    def epoch(self) -> Optional[int]:
        return self._pinned_epoch if self._pinned_epoch is not None else self._epoch

    def pin_epoch(self, epoch: Optional[int]) -> None:
        """Freeze the epoch this client declares (None unpins). A pinned
        client never re-adopts after a fence rejection."""
        self._pinned_epoch = epoch

    def _fenced(self, method: str, *args) -> Any:
        """A write carrying this client's epoch. On StaleEpochError a LIVE
        client re-adopts the head's epoch and retries once; a pinned
        client stays fenced."""
        try:
            return self._call(method, *args, _epoch=self.epoch)
        except StaleEpochError:
            if self._pinned_epoch is not None:
                raise
            self.adopt_epoch()
            return self._call(method, *args, _epoch=self._epoch)

    # ------------------------------------------------------------------- kv

    def kv_put(self, key: str, value: Any, namespace: str = "default",
               overwrite: bool = True) -> bool:
        return self._fenced("kv_put", key, value, namespace, overwrite)

    def kv_get(self, key: str, namespace: str = "default", default: Any = None) -> Any:
        return self._call("kv_get", key, namespace, default)

    def kv_delete(self, key: str, namespace: str = "default") -> bool:
        return self._fenced("kv_delete", key, namespace)

    def kv_keys(self, pattern: str = "*", namespace: str = "default") -> List[str]:
        return self._call("kv_keys", pattern, namespace)

    # --------------------------------------------------------------- pubsub

    def publish(self, channel: str, message: Any) -> None:
        self._fenced("publish", channel, message)

    def poll(self, channel: str, since: float = 0.0) -> List[Tuple[float, Any]]:
        return self._call("poll", channel, since)

    def subscribe_poll_loop(self, channel: str, callback, *, period_s: float = 0.2,
                            stop_event=None) -> None:
        """Long-poll subscription: invoke callback(message) for every
        message until stop_event is set. A transport failure backs off
        with jitter and resumes from the SAME `since` cursor, so a head
        outage never silently kills a watch loop."""
        since = 0.0
        failures = 0

        def _sleep(seconds: float) -> None:
            if stop_event is not None:
                stop_event.wait(seconds)
            else:
                time.sleep(seconds)

        while stop_event is None or not stop_event.is_set():
            try:
                msgs = self.poll(channel, since)
            except (RpcError, OSError):
                failures += 1
                wait = min(2.0, 0.1 * (2 ** min(failures, 5)))
                _sleep(wait * (0.5 + random.random()))
                continue
            failures = 0
            for ts, msg in msgs:
                since = max(since, ts)
                callback(msg)
            _sleep(period_s)

    # --------------------------------------------------------------- actors

    def list_named_actors(self, namespace: str = "default") -> List[str]:
        return self._call("list_named_actors", namespace)

    def has_named_actor(self, name: str, namespace: str = "default") -> bool:
        return self._call("has_named_actor", name, namespace)

    # ------------------------------------------------------- resource sync

    def report_resources(self, node_id: str, resources: Dict[str, float],
                         quiet_s: float = 0.0) -> None:
        """Broadcast this node's available resources; call periodically —
        stale views age out at the head. `quiet_s` > 0 keeps the view live
        that long without another report (a port head only)."""
        if quiet_s > 0:
            self._fenced("report_resources", node_id, resources, quiet_s)
        else:
            self._fenced("report_resources", node_id, resources)

    def cluster_view(self) -> Dict[str, Any]:
        """Aggregated live-node resource view."""
        return self._call("cluster_view")

    # ----------------------------------------------------- placement groups

    def pg_state(self, pg_hex: str) -> Optional[Dict[str, Any]]:
        """One placement group's recorded state, or None."""
        return self.kv_get(pg_hex, namespace=PG_NS)

    # ----------------------------------------------------- function export

    def register_function(self, name: str, fn) -> None:
        """Publish a function by reference through the KV store (the
        standard pickle: a peer must be able to import it). A function
        that `check_importable` refuses raises TypeError."""
        from .worker_pool import check_importable

        check_importable(fn, "an exported function")
        self.kv_put(name, pickle.dumps(fn, protocol=pickle.HIGHEST_PROTOCOL),
                    namespace=FUNC_NS)

    def fetch_function(self, name: str):
        """Resolve a published function; None if absent."""
        blob = self.kv_get(name, namespace=FUNC_NS)
        return None if blob is None else pickle.loads(blob)

    def ping(self) -> bool:
        return self._call("ping") == "ok"

    def close(self) -> None:
        self._rpc.close()
