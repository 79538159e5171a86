"""RPC: the cross-process control and data plane of a cluster.

Port of `ray_tpu/core/rpc.py`. The wire is JAX's, byte for byte: frames
of an 8-byte big-endian length and a pickle, over TCP, with the same
named methods, typed errors crossing the wire, per-call timeouts,
connection reuse and a retrying client, and the same HMAC
challenge-response handshake under `_AUTH_MAGIC` (which embeds
`PROTOCOL_VERSION`). A port client talks to a JAX `RpcServer` and a JAX
client to a port server, with or without a token.

Frame: 8-byte big-endian length | pickle((method, args, kwargs))
Reply: 8-byte length | pickle(("ok", value) | ("err", exception))

Tensors on the wire. Torch's own pickling of a tensor is a `torch.save`
blob of its whole storage; none of that crosses here. One reducer
(`_WirePickler.reducer_override`) serves every pickle this module and
`object_transfer.py` write: a tensor travels as its dtype, its shape and
one buffer — a numpy view of its (contiguous) memory, a dtype numpy lacks
(bf16, fp8) as the unsigned integer view of its width — which protocol 5
pickles out of band where the caller takes buffers (the chunked
transfer) and in band otherwise (a frame). A CPU tensor is not copied on
the sender unless it is not contiguous. A CUDA tensor is copied to the
host once on the sender (`stats["cuda_host_copies"]`) and rebuilt on the
receiving process's current CUDA device, as a pickled `jax.Array`
rebuilds on the receiver's default device; a receiver without CUDA
raises `DeviceUnavailableError`, naming its node. The process plane's
pipes keep their own rule (`worker_pool.dumps`: no CUDA tensor at all).

Every call passes chaos's RPC hook first (`chaos.rpc_action`): an armed
`rpc_delay_s`, `rpc_drop_prob` or `rpc_error_prob` delays the attempt,
severs the persistent connection, or fails it before the frame is sent
(so the retry policy may resend it), as in JAX.
"""

from __future__ import annotations

import hmac
import io
import logging
import os
import pickle
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HDR = struct.Struct(">Q")
MAX_FRAME = 1 << 31  # 2 GiB safety bound
# Wire-protocol generation, JAX's: token-authenticated connections embed
# it in the handshake magic below, BEFORE any pickle crosses. Cluster
# membership checks its own value at registration (cluster.py
# PORT_PROTOCOL), so a JAX node and a port node never join one cluster
# while their RPC layers stay compatible.
PROTOCOL_VERSION = 1
# Auth handshake prefix. The token check happens BEFORE any unpickling:
# a pickle payload on the wire is arbitrary code execution, so a server
# bound off-localhost must drop unauthenticated peers at the first frame.
# Challenge-response: the server sends a fresh nonce, the client answers
# HMAC-SHA256(token, nonce), so the token itself never crosses the wire.
_AUTH_MAGIC = b"RAYTPU-P%d-AUTH2:" % PROTOCOL_VERSION

# Counters of the tensor reducer (observability and the card tests).
stats = {"cuda_host_copies": 0}
_stats_lock = threading.Lock()


class RpcError(RuntimeError):
    """Transport-level failure (connection refused/reset, bad frame)."""


class RpcAuthError(RpcError):
    """The peer rejected (or required) the cluster auth token."""


class DeviceUnavailableError(RuntimeError):
    """A CUDA tensor arrived in a process without a CUDA device."""


# ------------------------------------------------------------------ tensors


def _this_node() -> str:
    from . import runtime as _rt

    ctx = getattr(_rt._global_runtime, "cluster", None)
    if ctx is not None:
        return f"node {ctx.node_id.hex()[:12]} at {ctx.address}"
    return f"host {socket.gethostname()} pid {os.getpid()}"


def _reduce_tensor(t):
    """(rebuild, args) of a tensor: dtype, shape, one numpy buffer."""
    torch = sys.modules["torch"]
    if t.layout != torch.strided or t.device.type not in ("cpu", "cuda"):
        raise TypeError(
            f"only strided CPU or CUDA tensors cross the cluster wire, not a "
            f"{t.layout} tensor on {t.device}"
        )
    host = t.detach()
    on_cuda = host.is_cuda
    if on_cuda:
        host = host.to("cpu", memory_format=torch.contiguous_format)
        with _stats_lock:
            stats["cuda_host_copies"] += 1
    host = host.resolve_conj().resolve_neg()
    if not host.is_contiguous():
        host = host.contiguous()
    try:
        arr = host.numpy()
    except TypeError:  # bf16, fp8, ...: the unsigned view of its width
        view = {1: torch.uint8, 2: torch.uint16, 4: torch.int32, 8: torch.int64}
        arr = host.view(view[host.element_size()]).numpy()
    dtype_name = str(t.dtype).split(".", 1)[1]
    return (_rebuild_tensor, (
        dtype_name, tuple(t.shape), arr.dtype.str, pickle.PickleBuffer(arr.reshape(-1)),
        "cuda" if on_cuda else "cpu", bool(t.requires_grad and t.is_leaf),
        isinstance(t, torch.nn.Parameter),
    ))


def _rebuild_tensor(dtype_name, shape, np_dtype, buf, device, requires_grad, parameter):
    import torch

    mem = memoryview(buf)
    if mem.readonly:
        buf = bytearray(mem)  # torch wants writable memory to share
    arr = np.frombuffer(buf, dtype=np.dtype(np_dtype))
    dtype = getattr(torch, dtype_name)
    t = torch.from_numpy(arr)
    if t.dtype != dtype:
        t = t.view(dtype)
    t = t.reshape(shape)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"a CUDA tensor {tuple(shape)} {dtype} arrived at {_this_node()}, "
                f"which has no CUDA device"
            )
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


class _WirePickler(pickle.Pickler):
    """The standard pickler with the wire's tensor reducer."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        return NotImplemented


def dumps(obj: Any, buffer_callback=None) -> bytes:
    """Pickle `obj` for the wire. With `buffer_callback` (protocol 5),
    tensor and numpy buffers go out of band to it; without, in band."""
    buf = io.BytesIO()
    # protocol 5 either way: a PickleBuffer pickles in band only at 5
    _WirePickler(buf, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return buf.getvalue()


# ------------------------------------------------------------------ frames


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    header = _HDR.pack(len(payload))
    if len(payload) < 1 << 16:
        sock.sendall(header + payload)
    else:  # a large frame is not copied once more to prepend 8 bytes
        sock.sendall(header)
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int, counter=None) -> bytearray:
    """Exactly n bytes, received into one preallocated buffer; `counter`
    [0] counts the bytes as they arrive."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            raise RpcError("connection closed mid-frame")
        got += k
        if counter is not None:
            counter[0] += k
    return buf


def _recv_frame(sock: socket.socket, counter=None) -> bytearray:
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size, counter))
    if length > MAX_FRAME:
        raise RpcError(f"frame of {length} bytes exceeds the 2 GiB bound")
    return _recv_exact(sock, length, counter)


class RpcServer:
    """Threaded TCP server dispatching named methods.

    handlers: {"method": callable(*args, **kwargs)}. A handler exception
    is pickled and re-raised client-side."""

    def __init__(self, handlers: Dict[str, Callable], host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None):
        self.handlers = dict(handlers)
        self._token = token or None
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if outer._token is not None and not self._authenticate(sock):
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                with outer._conns_lock:
                    outer._conns.add(sock)
                try:
                    self._serve_loop(sock)
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(sock)

            def _authenticate(self, sock) -> bool:
                """Challenge-response: send a fresh nonce, require
                HMAC(token, nonce) back — constant-time compare, NO
                unpickling before success."""
                nonce = os.urandom(32)
                try:
                    _send_frame(sock, _AUTH_MAGIC + nonce)
                    frame = _recv_frame(sock)
                except (RpcError, OSError):
                    return False
                expected = hmac.new(outer._token.encode(), nonce, "sha256").digest()
                if not hmac.compare_digest(frame, expected):
                    logger.warning("rpc: dropped unauthenticated connection from %s",
                                   self.client_address)
                    return False
                try:
                    _send_frame(sock, b"ok")
                except OSError:
                    return False
                return True

            def _serve_loop(self, sock):
                from ..util import tracing

                while True:
                    try:
                        frame = _recv_frame(sock)
                    except (RpcError, OSError):
                        return  # client went away
                    try:
                        method, args, kwargs = pickle.loads(frame)
                        # a client inside a sampled span injected its
                        # context as _trace_ctx: the handler runs in a
                        # server-side span parented back to the caller
                        ctx = tracing.extract_context(kwargs)
                        fn = outer.handlers.get(method)
                        if fn is None:
                            raise AttributeError(f"no rpc method {method!r}")
                        if ctx is not None:
                            with tracing.span(f"rpc.{method}", parent=ctx):
                                reply = ("ok", fn(*args, **kwargs))
                        else:
                            reply = ("ok", fn(*args, **kwargs))
                    except BaseException as exc:  # noqa: BLE001 - ferried to caller
                        try:
                            dumps(exc)
                            reply = ("err", exc)
                        except Exception:
                            reply = ("err", RuntimeError(repr(exc)))
                    try:
                        try:
                            payload = dumps(reply)
                        except Exception as exc:  # an unpicklable return value
                            payload = dumps(("err", RuntimeError(
                                f"rpc {method!r} returned an unpicklable value: {exc!r}")))
                        _send_frame(sock, payload)
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"rpc-server-{self.address[1]}",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def register(self, name: str, fn: Callable) -> None:
        self.handlers[name] = fn

    def stop(self) -> None:
        """Stop serving, sever live connections (a stopped server must not
        keep answering on old sockets) and join the serving thread."""
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=5.0)


class RpcClient:
    """One persistent connection with a bounded reconnect policy.

    Non-idempotent-safe: an attempt is retried ONLY when its request
    frame provably never reached the server whole — connect failures,
    send-phase failures, and the stale-persistent-connection case (a
    REUSED socket that died before yielding a single reply byte). A frame
    that was fully sent on a fresh connection is never resent: the
    handler may have executed.

    Thread-safe: calls serialize on a lock (open N clients for
    parallelism — connections are cheap)."""

    def __init__(self, address: str, *, timeout: Optional[float] = 30.0,
                 retries: Optional[int] = None,
                 retry_wait_s: Optional[float] = None,
                 token: Optional[str] = None):
        from .config import cfg

        host, _, port = address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._timeout = timeout
        # retries = reconnect attempts AFTER the first try
        self._retries = (
            retries if retries is not None
            else max(0, int(cfg.rpc_reconnect_attempts) - 1)
        )
        self._retry_wait = (
            retry_wait_s if retry_wait_s is not None
            else float(cfg.rpc_reconnect_backoff_s)
        )
        self._token = token or None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._token is not None:
            try:
                challenge = _recv_frame(sock)
            except RpcError:
                sock.close()
                raise RpcAuthError(
                    f"server {self._addr} sent no auth challenge (token "
                    f"configured here but not there?)"
                ) from None
            if not challenge.startswith(_AUTH_MAGIC):
                sock.close()
                raise RpcAuthError(f"bad auth challenge from {self._addr}")
            nonce = challenge[len(_AUTH_MAGIC):]
            digest = hmac.new(self._token.encode(), nonce, "sha256").digest()
            try:
                _send_frame(sock, digest)
                ack = _recv_frame(sock)
            except RpcError:
                sock.close()
                raise RpcAuthError(
                    f"server {self._addr} rejected the cluster auth token"
                ) from None
            if ack != b"ok":
                sock.close()
                raise RpcAuthError(f"bad auth ack from {self._addr}")
        return sock

    def _backoff(self, attempt: int) -> None:
        """Jittered exponential backoff between reconnect attempts."""
        import random

        wait = min(2.0, self._retry_wait * (2 ** attempt))
        time.sleep(wait * (0.5 + random.random()))

    def call(self, method: str, *args, **kwargs) -> Any:
        """Invoke a remote method; handler exceptions re-raise here,
        transport failures reconnect under the bounded policy (class
        docstring) then raise RpcError."""
        from . import chaos
        from ..util import tracing

        payload = dumps((method, args, tracing.inject_context(kwargs, method)))
        last: Optional[BaseException] = None
        t0 = time.time()
        attempt = 0
        for attempt in range(self._retries + 1):
            sent = False
            fresh = False
            reply_bytes = [0]
            try:
                act = chaos.rpc_action(method)
                if act is not None:
                    if act["delay"]:
                        time.sleep(act["delay"])
                    if act["drop"]:
                        self.close()  # sever: the attempt reconnects
                    if act["fail"]:
                        raise RpcError(f"chaos: injected rpc transport error on {method!r}")
                with self._lock:
                    if self._sock is None:
                        self._sock = self._connect()
                        fresh = True
                    _send_frame(self._sock, payload)
                    sent = True
                    frame = _recv_frame(self._sock, reply_bytes)
                if frame.startswith(_AUTH_MAGIC):
                    # a tokenless client on an auth-requiring server: the
                    # server's first frame is its challenge, not a reply
                    self.close()
                    raise RpcAuthError(f"server {self._addr} requires a cluster auth token")
                try:
                    status, value = pickle.loads(frame)
                except DeviceUnavailableError:
                    raise
                except Exception as exc:
                    raise RpcError(f"undecodable reply frame: {exc!r}") from None
            except (RpcAuthError, DeviceUnavailableError):
                raise  # wrong/missing token, or no device here: retrying cannot help
            except (OSError, RpcError) as exc:
                last = exc
                with self._lock:
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                # a fully-sent frame is resent only in the stale-connection
                # case: the REUSED socket died without a single reply byte
                # (_recv_frame counts them, so a reply torn mid-frame, which
                # proves the server got the request, is never resent)
                retry_safe = (not sent) or (not fresh and reply_bytes[0] == 0)
                if not retry_safe:
                    raise RpcError(
                        f"rpc {method!r} to {self._addr} failed after the "
                        f"request frame was delivered; not retried "
                        f"(non-idempotent): {exc!r}"
                    ) from exc
                if attempt < self._retries:
                    self._backoff(attempt)
                continue
            # handler errors re-raise OUTSIDE the retried try: one that
            # subclasses OSError must not be mistaken for a transport fault
            if attempt > 0:
                ctx = tracing.current_context()
                if ctx is not None:
                    tracing.tracer().record_span(
                        "rpc.client_retries", t0, time.time(), parent=ctx,
                        attrs={"method": method, "attempts": attempt + 1},
                    )
            if status == "err":
                raise value
            return value
        raise RpcError(f"rpc to {self._addr} failed after retries: {last!r}")

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def __getattr__(self, method: str) -> Callable:
        if method.startswith("_"):
            raise AttributeError(method)
        return lambda *a, **kw: self.call(method, *a, **kw)
