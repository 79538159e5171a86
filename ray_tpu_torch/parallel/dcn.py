"""Cross-slice (DCN) transfer service: ship training state to a peer node
while compute continues.

Port of `ray_tpu/parallel/dcn.py`. Checkpoint replication, parameter
serving and cross-silo copies ride TCP in the background while the
collectives ride the fast fabric. The pipeline:

    tensors --(snapshot at the call)--> a private copy
    --(background thread: device -> pinned host on a side stream)--> CPU
    --(chunked out-of-band push, core/object_transfer)--> peer's store

A pytree is any nesting of dicts, lists, tuples and dataclasses (the
port's `TrainState` and `AdamWState` included) over tensors, numpy
arrays and plain values.

**The snapshot is taken at the call.** JAX snapshots device arrays by
reference because they are immutable; torch tensors are not, and an
optimizer step writes the parameters in place. So `replicate_async`
copies every tensor leaf before it returns: a CUDA leaf is cloned on the
device on the caller's current stream (it returns at once: the clone is
only enqueued, and any later in-place write on that stream runs after
it), a CPU tensor or numpy leaf is copied on the host, as JAX copies
numpy leaves. The background thread then waits for the clones on a side
stream and copies them into pinned host memory there, so the device to
host copy overlaps the caller's next steps instead of queueing behind
them. No later in-place step can tear the replica.

The peer materializes the pytree under a key derived id, with tensors as
CPU tensors of the leaves' dtypes and shapes (JAX's replica is host
numpy). `quantize="int8"` block-quantizes float leaves of 4096 elements
or more on the host before the push (JAX's layout, bit for bit on numpy
leaves; a bf16 or f16 tensor leaf goes through f32 and comes back in its
dtype); `fetch_replica` dequantizes.

Usage (the peer is any cluster node's agent address)::

    rep = CrossSliceReplicator(peer_addr=node.agent_addr, token=token)
    for step in range(...):
        loss = train_step(state, batch)
        if step % 100 == 0:
            rep.replicate_async("trainstate", state)   # returns at once
    rep.wait()

On the peer::

    state = fetch_replica("trainstate")   # from its own store
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

REPLICA_NS_PREFIX = "_dcn_replica/"
_Q8_MARKER = "__dcn_int8__"
_Q8_BLOCK = 512
_Q8_MIN_ELEMS = 4096  # below this the scales' overhead beats the savings


def _tree_map(fn: Callable[[Any], Any], tree: Any,
              is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Apply `fn` to every leaf of a nest of dicts, lists, tuples and
    dataclass instances, keeping the containers' types."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v, is_leaf)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a namedtuple
        return type(tree)(*(_tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name), is_leaf)
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def _tree_leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(getattr(leaf, "nbytes", 0))


def _quantize_leaf(x: Any) -> Any:
    """Host-side blockwise int8 quantization of one float leaf (the block
    layout of the quantized collectives, for the wire: a replica mirror
    tolerates ~1e-2 relative error and the payload shrinks ~3.9x).
    Non-float and small leaves pass through. A CPU float tensor goes
    through f32 numpy and records its dtype, so it comes back as a tensor
    of that dtype."""
    torch_dtype = None
    if isinstance(x, torch.Tensor) and x.is_floating_point() and x.numel() >= _Q8_MIN_ELEMS:
        torch_dtype = str(x.dtype).rsplit(".", 1)[-1]
        x = x.detach().to(torch.float32).numpy()
    if not isinstance(x, np.ndarray) or x.dtype.kind != "f" or x.size < _Q8_MIN_ELEMS:
        return x
    flat = x.astype(np.float32).reshape(-1)
    pad = (-flat.size) % _Q8_BLOCK
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _Q8_BLOCK)
    amax = np.abs(blocks).max(axis=1)
    scales = np.where(amax == 0.0, 1.0, amax / 127.0).astype(np.float32)
    values = np.clip(np.rint(blocks / scales[:, None]), -127, 127).astype(np.int8)
    out = {
        _Q8_MARKER: True,
        "values": values,
        "scales": scales,
        "shape": tuple(x.shape),
        "dtype": x.dtype.str,
    }
    if torch_dtype is not None:
        out["torch_dtype"] = torch_dtype
    return out


def _dequantize_leaf(leaf: Any) -> Any:
    if not _is_q8(leaf):
        return leaf
    flat = (leaf["values"].astype(np.float32) * leaf["scales"][:, None]).reshape(-1)
    size = int(np.prod(leaf["shape"])) if leaf["shape"] else 1
    out = flat[:size].reshape(leaf["shape"]).astype(np.dtype(leaf["dtype"]))
    if "torch_dtype" in leaf:
        return torch.from_numpy(out).to(getattr(torch, leaf["torch_dtype"]))
    return out


def _is_q8(leaf: Any) -> bool:
    return isinstance(leaf, dict) and bool(leaf.get(_Q8_MARKER))


def _snapshot_leaf(x: Any) -> Any:
    """The leaf's value at this moment, private to the replicator."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()  # a CUDA clone is enqueued on the current stream
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    return x


class CrossSliceReplicator:
    """Background pipeline shipping pytrees of tensors and arrays to a
    peer node's object store. One replication runs at a time: a newer
    snapshot supersedes one accepted but not yet started (the mirror
    wants the latest state, not every state)."""

    def __init__(self, peer_addr: str, *, token: Optional[str] = None,
                 quantize: Optional[str] = None):
        """quantize="int8" block-quantizes float leaves on the host before
        the push (the wire carries ~1/4 of the bytes; fetch_replica
        dequantizes). None ships exact bytes."""
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = quantize
        self.peer_addr = peer_addr
        self._token = token
        # one condition guards _next / _stop and carries the wakeups
        self._cond = threading.Condition()
        self._next: Optional[tuple] = None  # (key, pytree, ready event); latest wins  # guarded-by: _cond
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False  # guarded-by: _cond
        self._error: Optional[BaseException] = None
        self.stats = {"replicated": 0, "superseded": 0, "bytes": 0, "raw_bytes": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ray_tpu_torch-dcn-replicator")
        self._thread.start()

    # ------------------------------------------------------------- public

    def replicate_async(self, key: str, pytree: Any) -> None:
        """Snapshot `pytree` and ship it in the background. Returns at
        once; a previous snapshot that has not started is superseded.
        Every tensor and array leaf is copied here (a CUDA leaf on the
        device, enqueued on the current stream), so the caller may write
        its tensors in place as soon as this returns."""
        snapshot = _tree_map(_snapshot_leaf, pytree)
        ready = None
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in _tree_leaves(snapshot)):
            ready = torch.cuda.Event()
            ready.record()  # the clones are done when this fires
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        with self._cond:
            if self._stop:
                raise RuntimeError("replicator is closed")
            if self._next is not None:
                self.stats["superseded"] += 1
            self._next = (key, snapshot, ready)
            self._idle.clear()
            self._cond.notify()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted snapshot has reached the peer."""
        ok = self._idle.wait(timeout)
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        return ok

    def close(self) -> None:
        """Ship the accepted snapshot (if any), then stop: an accepted
        replicate_async is a promise, and close() keeps it."""
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout=60)
        self._idle.set()  # even on a join timeout, never strand a wait()

    # -------------------------------------------------------------- loop

    @staticmethod
    def _to_host(pytree: Any, ready) -> Any:
        """CUDA leaves to pinned host memory on a side stream, after the
        clones (`ready`); CPU leaves as they are."""
        if ready is None:
            return pytree
        side = torch.cuda.Stream()
        side.wait_event(ready)
        with torch.cuda.stream(side):
            def copy(x):
                if not (isinstance(x, torch.Tensor) and x.is_cuda):
                    return x
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                x.record_stream(side)
                return host

            host_tree = _tree_map(copy, pytree)
        side.synchronize()
        return host_tree

    def _loop(self) -> None:
        from ..core.object_transfer import push_object
        from ..core.rpc import RpcClient

        client: Optional[RpcClient] = None
        while True:
            with self._cond:
                while self._next is None and not self._stop:
                    self._cond.wait()
                if self._next is None:  # stop requested, nothing pending
                    break
                item, self._next = self._next, None
            key, pytree, ready = item
            try:
                host_tree = self._to_host(pytree, ready)
                del pytree  # the device clones are freed here
                raw_bytes = sum(_nbytes(leaf) for leaf in _tree_leaves(host_tree))
                if self.quantize == "int8":
                    host_tree = _tree_map(_quantize_leaf, host_tree)
                nbytes = sum(_nbytes(leaf) for leaf in _tree_leaves(host_tree))
                if client is None:
                    client = RpcClient(self.peer_addr, timeout=600.0, retries=1,
                                       token=self._token)
                # to the peer's store, chunked and out of band, under an id
                # the peer derives from the key (a fresh replication
                # re-seals over the previous one)
                push_object(self.peer_addr, _replica_oid(key).hex(), host_tree, client=client)
                self.stats["replicated"] += 1
                self.stats["bytes"] += int(nbytes)
                self.stats["raw_bytes"] += int(raw_bytes)
            except BaseException as exc:  # noqa: BLE001 - surfaced on the next call
                self._error = exc
                if client is not None:
                    client.close()
                    client = None
            finally:
                with self._cond:
                    if self._next is None:
                        self._idle.set()
        if client is not None:
            client.close()


def fetch_replica(key: str, runtime=None) -> Any:
    """Peer side: the latest replicated pytree under `key`, from this
    node's store (KeyError if nothing arrived yet). int8 leaves are
    dequantized."""
    from ..core import runtime as _rt

    rt = runtime or _rt.get_runtime()
    oid = _replica_oid(key)
    entry = rt.object_store.entry(oid)
    if entry is None or not entry.event.is_set():
        raise KeyError(f"no replica {key!r} has arrived on this node")
    tree = rt.object_store.get(oid)
    return _tree_map(_dequantize_leaf, tree, is_leaf=_is_q8)


def _replica_oid(key: str):
    """Replicas live under ids derived from the key, so the peer resolves
    them without a directory round trip and a fresh replication replaces
    the previous one."""
    import hashlib

    from ..core.ids import ObjectID

    digest = hashlib.blake2b((REPLICA_NS_PREFIX + key).encode(), digest_size=20).hexdigest()
    return ObjectID(digest)
