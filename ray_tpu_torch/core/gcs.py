"""Global control store: KV, pub/sub and the named-actor registry.

Port of `ray_tpu/core/gcs.py` for one process: the namespaced KV store,
the publish/subscribe channels with their bounded history, and the
named-actor table, and the cluster epoch that the GCS service's fence
reads (`current_epoch`, `bump_epoch`). The JAX package's durability
(periodic snapshots, the mutation WAL, `restore`) comes with the head's
restart: ROADMAP A6b (head restart).
"""

from __future__ import annotations

import fnmatch
import logging
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
# record (meta only; artifact bytes stay in the runtime's ProfileStore)
PROFILE_NS = "_profiles"


class KVStore:
    """Namespaced key-value store (reference: gcs_kv_manager.h)."""

    def __init__(self):
        self._data: Dict[Tuple[str, str], Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def put(self, key: str, value: Any, namespace: str = "default", overwrite: bool = True) -> bool:
        with self._lock:
            k = (namespace, key)
            if not overwrite and k in self._data:
                return False
            self._data[k] = value
            return True

    def get(self, key: str, namespace: str = "default", default: Any = None) -> Any:
        with self._lock:
            return self._data.get((namespace, key), default)

    def delete(self, key: str, namespace: str = "default") -> bool:
        with self._lock:
            return self._data.pop((namespace, key), None) is not None

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
    """Composite control plane: KV + pubsub + named-actor registry."""

    def __init__(self):
        self.kv = KVStore()
        self.pubsub = PubSub()
        self._named_actors: Dict[Tuple[str, str], Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def current_epoch(self) -> int:
        """The cluster epoch: bumped on every head restore so writes from
        before the restart are fenceable (`gcs_service._fence`)."""
        return int(self.kv.get(EPOCH_KEY, namespace=HEAD_NS, default=0))

    def bump_epoch(self) -> int:
        """Advance the epoch (a KV write like any other)."""
        epoch = self.current_epoch() + 1
        self.kv.put(EPOCH_KEY, epoch, namespace=HEAD_NS)
        return epoch

    def register_named_actor(self, name: str, handle: Any, namespace: str = "default") -> None:
        with self._lock:
            key = (namespace, name)
            if self._named_actors.get(key) is not None:
                raise ValueError(f"Actor name {name!r} already taken in namespace {namespace!r}")
            self._named_actors[key] = handle
        self.pubsub.publish("actors", {"event": "registered", "name": name})

    def get_named_actor(self, name: str, namespace: str = "default") -> Optional[Any]:
        with self._lock:
            return self._named_actors.get((namespace, name))

    def unregister_named_actor(self, name: str, namespace: str = "default") -> None:
        with self._lock:
            self._named_actors.pop((namespace, name), None)

    def list_named_actors(self, namespace: str = "default") -> List[str]:
        with self._lock:
            return [n for (ns, n) in self._named_actors if ns == namespace]
