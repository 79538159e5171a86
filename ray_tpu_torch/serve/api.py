"""serve public API: run/get_handle/status/delete/shutdown + HTTP ingress.

Port of `ray_tpu/serve/api.py`. The first call starts the runtime with
its defaults (`ray_tpu_torch.init()`, which detects the CUDA devices) and
the controller. The proxy is a threaded stdlib HTTP server routing JSON
POSTs to deployment handles: `POST /<deployment>[/<method>]` with
`?stream=1` for chunked JSON lines, `model_id`, `timeout_s`, `tenant` and
`priority` query parameters, typed errors mapped to 404 / 429 / 503 / 504.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from .. import api as _core_api
from .controller import ServeController
from .deployment import Application
from .router import DeploymentHandle

_controller: Optional[ServeController] = None
_proxy: Optional["_HttpProxy"] = None
_lock = threading.Lock()


def _get_controller() -> ServeController:
    global _controller
    with _lock:
        if _controller is None:
            _core_api.init()  # make sure the runtime exists
            _controller = ServeController()
        return _controller


def run(app: Application, *, name: Optional[str] = None) -> DeploymentHandle:
    """Deploy (or redeploy) an application; returns its handle."""
    if name is not None:
        app = Application(app.deployment.options(name=name), app.init_args, app.init_kwargs)
    return _get_controller().deploy(app)


def get_handle(name: str) -> DeploymentHandle:
    return _get_controller().get_handle(name)


def status() -> Dict[str, Dict[str, Any]]:
    return _get_controller().status()


def delete(name: str) -> None:
    _get_controller().delete(name)


def shutdown() -> None:
    """Stop the HTTP proxy, delete every deployment (its replicas killed
    and their threads joined) and stop the controller and the router's
    reaper. The runtime stays up (`ray_tpu_torch.shutdown()` stops it)."""
    global _controller, _proxy
    with _lock:
        if _proxy is not None:
            _proxy.stop()
            _proxy = None
        if _controller is not None:
            _controller.shutdown()
            _controller = None
    from .router import _Reaper

    _Reaper.shutdown()


# ------------------------------------------------------------------ HTTP proxy


class EgresslessHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that skips the default server_bind's
    socket.getfqdn() — a reverse-DNS lookup that hangs on a host with no
    network. Shared by the serve proxy and the OpenAI frontend."""

    daemon_threads = True

    def server_bind(self):
        import socketserver

        socketserver.TCPServer.server_bind(self)
        self.server_name = self.server_address[0]
        self.server_port = self.server_address[1]


def write_chunk(wfile, data: bytes) -> None:
    """One HTTP/1.1 chunked-transfer frame."""
    wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
    wfile.flush()


class _HttpProxy:
    def __init__(self, controller: ServeController, host: str, port: int):
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer is illegal on HTTP/1.0; spec-compliant
            # clients only dechunk 1.1 responses
            protocol_version = "HTTP/1.1"

            def do_POST(self):  # noqa: N802
                from . import reqlog

                # end-to-end forensics id: honor the client's
                # x-request-id, else mint one at first touch
                request_id = (
                    self.headers.get("x-request-id")
                    or reqlog.new_request_id()
                )
                retry_after = None
                try:
                    from urllib.parse import parse_qs, urlsplit

                    url = urlsplit(self.path)
                    reqlog.mark(request_id, "http.received", path=url.path)
                    query = parse_qs(url.query)
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    # path = /<deployment>[/<method>][?stream=1][&model_id=m]
                    #        [&timeout_s=5]
                    parts = [p for p in url.path.split("/") if p]
                    if not parts:
                        raise KeyError("missing deployment in path")
                    handle = controller.get_handle(parts[0])
                    model_id = query.get("model_id", [None])[0]
                    if model_id:
                        handle = handle.options(multiplexed_model_id=model_id)
                    timeout_s = query.get("timeout_s", [None])[0]
                    if timeout_s:
                        handle = handle.options(timeout_s=float(timeout_s))
                    # tenant/priority: query param wins, headers fall back
                    # (same resolution the OpenAI front-end does)
                    from . import tenancy

                    tenant = query.get("tenant", [None])[0]
                    priority = query.get("priority", [None])[0]
                    if tenant is None and priority is None:
                        tenant, h_priority = tenancy.resolve_http_tenant(
                            self.headers
                        )
                        priority = h_priority
                    if tenant is not None or priority is not None:
                        handle = handle.options(
                            tenant=tenant,
                            priority=(
                                int(priority) if priority is not None else None
                            ),
                        )
                    handle = handle.options(request_id=request_id)
                    method = parts[1] if len(parts) > 1 else "__call__"
                    if query.get("stream", ["0"])[0] in ("1", "true"):
                        self._stream_response(handle, method, payload,
                                              request_id)
                        return
                    ref = getattr(handle, method).remote(payload) if method != "__call__" else handle.remote(payload)
                    result = _core_api.get(ref, timeout=120)
                    body = json.dumps({
                        "result": result, "request_id": request_id,
                    }).encode()
                    self.send_response(200)
                except KeyError as e:
                    body = json.dumps({
                        "error": f"not found: {e}",
                        "request_id": request_id,
                    }).encode()
                    self.send_response(404)
                except Exception as e:
                    # typed serve errors keep their HTTP semantics: shed →
                    # 429 + Retry-After, no replicas → 503, deadline → 504
                    from ..core.exceptions import (
                        BackPressureError,
                        DeploymentUnavailableError,
                        GetTimeoutError,
                        ReplicaDrainingError,
                        RequestTimeoutError,
                        unwrap_error,
                    )

                    cause = unwrap_error(e)
                    if isinstance(cause, BackPressureError):
                        # honest Retry-After: token-bucket refill or queue
                        # drain-rate estimate when the shedder computed one
                        import math

                        retry = getattr(cause, "retry_after_s", None)
                        code = 429
                        retry_after = (
                            max(1, int(math.ceil(float(retry))))
                            if retry and retry > 0 else 1
                        )
                    elif isinstance(
                        cause, (DeploymentUnavailableError, ReplicaDrainingError)
                    ):
                        code, retry_after = 503, 1
                    elif isinstance(
                        cause, (RequestTimeoutError, GetTimeoutError)
                    ):
                        code = 504
                    else:
                        code = 500
                    # request_id rides NEXT TO Retry-After: a shed client
                    # can quote it to find the request's marks
                    body = json.dumps({
                        "error": repr(cause), "request_id": request_id,
                    }).encode()
                    self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.send_header("x-request-id", request_id)
                self.end_headers()
                self.wfile.write(body)

            def _stream_response(self, handle, method, payload,
                                 request_id=None) -> None:
                """Chunked transfer: one JSON line per yielded item. Items
                flow as the replica's generator produces them — backed by
                num_returns='streaming' on the actor call."""
                caller = handle.options(stream=True)
                stream = (
                    caller.remote(payload) if method == "__call__"
                    else getattr(caller, method).remote(payload)
                )
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.send_header("Transfer-Encoding", "chunked")
                if request_id is not None:
                    self.send_header("x-request-id", request_id)
                self.end_headers()

                def chunk(data: bytes) -> None:
                    write_chunk(self.wfile, data)

                try:
                    for ref in stream:
                        item = _core_api.get(ref, timeout=120)
                        chunk((json.dumps({"result": item}) + "\n").encode())
                except Exception as e:  # noqa: BLE001 - surfaces as final line
                    chunk((json.dumps({"error": repr(e)}) + "\n").encode())
                self.wfile.write(b"0\r\n\r\n")

            def log_message(self, *args):  # silence request logs
                pass

        self.server = EgresslessHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True, name="serve-http"
        )
        self.thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


def start_http(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the HTTP ingress; returns the bound port."""
    global _proxy
    controller = _get_controller()  # before taking _lock: it locks too
    with _lock:
        if _proxy is None:
            _proxy = _HttpProxy(controller, host, port)
        return _proxy.port
