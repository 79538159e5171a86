"""Node-to-node object transfer: chunked pull and push over RPC.

Port of `ray_tpu/core/object_transfer.py`. This plane carries objects
between the runtime processes of a cluster (driver, node agents): a value
is pickled with protocol 5 and out-of-band buffers (`rpc.dumps`, whose
tensor reducer hands a tensor's memory over as one buffer), so a numpy or
tensor payload is never copied into one monolithic pickle blob. The
sender serves `CHUNK_BYTES` windows straight out of the original buffers
(memoryview slices, copied only into the reply frame's pickle), the
receiver assembles each buffer into a preallocated bytearray and rebuilds
with ``pickle.loads(meta, buffers=...)``: peak memory stays about 1x the
object on each side. A CUDA tensor is the exception the wire makes: one
host copy on the sender, rebuilt on the receiver's current CUDA device
(`rpc.py`). Transfers a peer abandons mid-flight are swept after
`TRANSFER_TTL_S`, so a dead client cannot pin gigabytes in the serving
process.
"""

from __future__ import annotations

import pickle
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .ids import ObjectID
from .rpc import RpcClient, RpcServer, dumps

CHUNK_BYTES = 4 << 20  # 4 MiB windows
TRANSFER_TTL_S = 120.0  # sweep abandoned transfers after this long


def _dumps_oob(value: Any) -> Tuple[bytes, List[memoryview]]:
    """Pickle with out-of-band buffers: returns (meta, raw buffers)."""
    buffers: List[pickle.PickleBuffer] = []
    meta = dumps(value, buffer_callback=buffers.append)
    return meta, [pb.raw() for pb in buffers]


class _Transfer:
    """One in-flight transfer: the meta pickle plus its raw buffers
    (outgoing) or preallocated assembly bytearrays (incoming)."""

    __slots__ = ("meta", "buffers", "last_active")

    def __init__(self, meta: Any, buffers: List[Any]):
        self.meta = meta
        self.buffers = buffers
        self.last_active = time.monotonic()


class ObjectTransferServer:
    """Expose a runtime's object store for remote pull and push."""

    def __init__(self, object_store, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None):
        self._store = object_store
        self._lock = threading.Lock()
        self._outgoing: Dict[str, _Transfer] = {}  # guarded-by: _lock
        self._incoming: Dict[str, _Transfer] = {}  # guarded-by: _lock
        self._server = RpcServer(
            {
                "ping": lambda: "ok",
                "pull_begin": self._pull_begin,
                "pull_chunk": self._pull_chunk,
                "pull_end": self._pull_end,
                "push_begin": self._push_begin,
                "push_chunk": self._push_chunk,
                "push_end": self._push_end,
            },
            host=host,
            port=port,
            token=token,
        )
        self.address = self._server.url

    def register(self, name: str, fn) -> None:
        """Expose an extra RPC method on this server (the cluster node
        agent rides the same port: one well-known address per node)."""
        self._server.register(name, fn)

    def _sweep(self, now: float) -> None:  # holds-lock: _lock
        """Drop transfers older than the TTL. A client that died mid-pull
        must not pin its payload forever."""
        for table in (self._outgoing, self._incoming):
            stale = [tid for tid, tr in table.items()
                     if now - tr.last_active > TRANSFER_TTL_S]
            for tid in stale:
                del table[tid]

    # ----------------------------------------------------------------- pull

    def _pull_begin(self, oid_hex: str, timeout: float = 30.0) -> Dict[str, Any]:
        value = self._store.get(ObjectID(oid_hex), timeout=timeout)
        meta, buffers = _dumps_oob(value)
        transfer_id = uuid.uuid4().hex
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            self._outgoing[transfer_id] = _Transfer(meta, buffers)
        return {
            "transfer_id": transfer_id,
            "meta_nbytes": len(meta),
            "buffer_nbytes": [len(b) for b in buffers],
        }

    def _pull_chunk(self, transfer_id: str, buf_index: int, offset: int):
        """Serve one window. buf_index -1 addresses the meta pickle,
        0..N-1 the out-of-band buffers; a window is a view of the original
        object's memory that the reply pickles in band (a bytes or
        bytearray on the wire, as JAX's bytes)."""
        with self._lock:
            tr = self._outgoing.get(transfer_id)
        if tr is None:
            raise KeyError(f"unknown transfer {transfer_id!r}")
        tr.last_active = time.monotonic()  # a slow-but-live pull never expires
        src = tr.meta if buf_index < 0 else tr.buffers[buf_index]
        return pickle.PickleBuffer(memoryview(src)[offset : offset + CHUNK_BYTES])

    def _pull_end(self, transfer_id: str) -> bool:
        with self._lock:
            return self._outgoing.pop(transfer_id, None) is not None

    # ----------------------------------------------------------------- push

    def _push_begin(self, oid_hex: str, meta_nbytes: int,
                    buffer_nbytes: List[int]) -> str:
        transfer_id = uuid.uuid4().hex
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            self._incoming[transfer_id] = _Transfer(
                bytearray(meta_nbytes), [bytearray(n) for n in buffer_nbytes]
            )
        return transfer_id

    def _push_chunk(self, transfer_id: str, buf_index: int, offset: int,
                    chunk: bytes) -> None:
        with self._lock:
            tr = self._incoming.get(transfer_id)
        if tr is None:
            raise KeyError(f"unknown transfer {transfer_id!r}")
        tr.last_active = time.monotonic()
        dst = tr.meta if buf_index < 0 else tr.buffers[buf_index]
        if offset + len(chunk) > len(dst):
            # bytearray slice-assign past the end APPENDS; reject instead
            raise ValueError(
                f"push chunk [{offset}:{offset + len(chunk)}] exceeds "
                f"buffer of {len(dst)} bytes"
            )
        dst[offset : offset + len(chunk)] = chunk

    def _push_end(self, transfer_id: str, oid_hex: str) -> bool:
        with self._lock:
            tr = self._incoming.pop(transfer_id, None)
        if tr is None:
            raise KeyError(f"unknown transfer {transfer_id!r}")
        value = pickle.loads(bytes(tr.meta), buffers=tr.buffers)
        oid = ObjectID(oid_hex)
        self._store.create(oid)
        self._store.seal(oid, value)
        return True

    def stop(self) -> None:
        self._server.stop()


def _windows(nbytes: int):
    offset = 0
    while offset < nbytes:  # zero-length buffers need no transfer at all
        yield offset
        offset += CHUNK_BYTES


def fetch_object(address: str, oid_hex: str, *, timeout: float = 30.0,
                 client: Optional[RpcClient] = None,
                 token: Optional[str] = None) -> Any:
    """Pull one object from a remote ObjectTransferServer: begin, fetch
    every window, end, reassemble."""
    from ..util import tracing

    own = client is None
    client = client or RpcClient(address, timeout=timeout, token=token)
    try:
        with tracing.span("transfer.pull", peer=address, oid=oid_hex) as sp:
            info = client.call("pull_begin", oid_hex, timeout)
            tid = info["transfer_id"]
            meta = bytearray(info["meta_nbytes"])
            buffers = [bytearray(n) for n in info["buffer_nbytes"]]
            sp.set_attribute("nbytes", info["meta_nbytes"] + sum(info["buffer_nbytes"]))
            for buf_index, dst in [(-1, meta)] + list(enumerate(buffers)):
                for offset in _windows(len(dst)):
                    chunk = client.call("pull_chunk", tid, buf_index, offset)
                    dst[offset : offset + len(chunk)] = chunk
            client.call("pull_end", tid)
            return pickle.loads(bytes(meta), buffers=buffers)
    finally:
        if own:
            client.close()


def push_object(address: str, oid_hex: str, value: Any, *,
                timeout: float = 30.0,
                client: Optional[RpcClient] = None,
                token: Optional[str] = None) -> None:
    """Push one object into a remote runtime's store. Windows slice the
    original buffers — no monolithic payload copy on the sender."""
    from ..util import tracing

    meta, buffers = _dumps_oob(value)
    own = client is None
    client = client or RpcClient(address, timeout=timeout, token=token)
    try:
        with tracing.span("transfer.push", peer=address, oid=oid_hex,
                          nbytes=len(meta) + sum(len(b) for b in buffers)):
            tid = client.call("push_begin", oid_hex, len(meta), [len(b) for b in buffers])
            for buf_index, src in [(-1, memoryview(meta))] + [
                (i, memoryview(b)) for i, b in enumerate(buffers)
            ]:
                for offset in _windows(len(src)):
                    client.call("push_chunk", tid, buf_index, offset,
                                pickle.PickleBuffer(src[offset : offset + CHUNK_BYTES]))
            client.call("push_end", tid, oid_hex)
    finally:
        if own:
            client.close()
