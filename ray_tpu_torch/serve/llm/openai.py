"""OpenAI-compatible serving surface: /v1/completions,
/v1/chat/completions (SSE streaming), /v1/models.

Port of `ray_tpu/serve/llm/openai.py`: an OpenAI-schema HTTP frontend
over LLMServer deployments. No tokenizer vocab files ship with the repo,
so text is encoded with a built-in byte-level tokenizer (UTF-8 bytes =
token ids < 256 — an exact fit for the *-tiny model family's vocab of
256; larger models accept OpenAI's token-array `prompt` form directly,
which the real OpenAI API also supports, and their generated ids >= 256
have no text). The HTTP layer is the same stdlib threaded server as
serve's proxy.

Routing: the request's `model` field resolves to a serve deployment
(one app per model), so multiple models can be mounted on one port.
"""

from __future__ import annotations

import json
import math
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional

from ...core.exceptions import (
    BackPressureError,
    DeploymentUnavailableError,
    GetTimeoutError,
    ReplicaDrainingError,
    RequestTimeoutError,
    unwrap_error,
)
from .. import api as serve_api
from .. import reqlog
from ..api import EgresslessHTTPServer, write_chunk


def _http_status_for(err: BaseException):
    """(status, error-type, retry_after | None) for a serve-layer typed
    error, or None when `err` is not an overload/availability/deadline
    condition. BackPressure → 429 (client should back off and retry),
    unavailability/draining → 503, deadline expiry → 504.

    The 429 Retry-After is computed from the shed's own estimate when it
    carries one (token-bucket refill time, router queue drain rate);
    otherwise the historical 1-second default."""
    cause = unwrap_error(err)
    if isinstance(cause, BackPressureError):
        return 429, "overloaded_error", _retry_after_s(cause)
    if isinstance(cause, (DeploymentUnavailableError, ReplicaDrainingError)):
        return 503, "service_unavailable_error", 1
    if isinstance(cause, (RequestTimeoutError, GetTimeoutError)):
        return 504, "timeout_error", None
    return None


def _retry_after_s(cause: BaseException) -> int:
    retry = getattr(cause, "retry_after_s", None)
    if not retry or retry <= 0:
        return 1
    return max(1, int(math.ceil(float(retry))))


class ByteTokenizer:
    """UTF-8 byte-level fallback tokenizer (token id == byte value)."""

    @staticmethod
    def encode(text: str) -> List[int]:
        return list(text.encode("utf-8"))

    @staticmethod
    def decode(tokens: List[int]) -> str:
        return bytes(t for t in tokens if 0 <= t < 256).decode(
            "utf-8", errors="replace"
        )


def _chat_prompt(messages: List[Dict[str, str]]) -> str:
    """Minimal chat template (a model's own template comes from its
    tokenizer config; none ships with the repo)."""
    lines = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)


class OpenAIFrontend:
    """HTTP frontend translating the OpenAI schema onto LLMServer
    deployment handles. `models` maps a model id (the request's `model`
    field) to a serve deployment name hosting it."""

    def __init__(self, models: Dict[str, str], host: str = "127.0.0.1",
                 port: int = 0):
        self.models = dict(models)
        self.created = int(time.time())
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _json(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                rid = getattr(self, "_request_id", None)
                if rid:
                    self.send_header("x-request-id", rid)
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, message: str, etype: str,
                       retry_after: Optional[int] = None) -> None:
                err: Dict[str, Any] = {
                    "message": message, "type": etype, "param": None,
                    "code": None,
                }
                rid = getattr(self, "_request_id", None)
                if rid:
                    # the forensics key lands NEXT TO Retry-After so a
                    # shed/timed-out client can quote it
                    err["request_id"] = rid
                body = json.dumps({"error": err}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                if rid:
                    self.send_header("x-request-id", rid)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - /v1/models
                if self.path.rstrip("/") == "/v1/models":
                    self._json(200, {
                        "object": "list",
                        "data": [
                            {"id": mid, "object": "model",
                             "created": frontend.created,
                             "owned_by": "ray_tpu"}
                            for mid in frontend.models
                        ],
                    })
                else:
                    self._error(404, f"no route {self.path}", "invalid_request_error")

            def do_POST(self):  # noqa: N802
                # stable end-to-end request id: the caller's x-request-id
                # wins (idempotent client retries keep one forensics
                # timeline); otherwise mint one here, at first touch
                self._request_id = (
                    self.headers.get("x-request-id")
                    or reqlog.new_request_id()
                )
                reqlog.mark(self._request_id, "http.received",
                            path=self.path.rstrip("/"))
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except Exception:
                    self._error(400, "request body is not valid JSON",
                                "invalid_request_error")
                    return
                path = self.path.rstrip("/")
                try:
                    if path == "/v1/completions":
                        frontend._completions(self, req, chat=False)
                    elif path == "/v1/chat/completions":
                        frontend._completions(self, req, chat=True)
                    else:
                        self._error(404, f"no route {path}",
                                    "invalid_request_error")
                except KeyError as e:
                    self._error(404, f"model not found: {e}",
                                "invalid_request_error")
                except ValueError as e:
                    self._error(400, str(e), "invalid_request_error")
                except Exception as e:  # noqa: BLE001 - schema'd 500
                    mapped = _http_status_for(e)
                    cause = unwrap_error(e)
                    if mapped is not None:
                        code, etype, retry_after = mapped
                        self._error(code, str(cause), etype,
                                    retry_after=retry_after)
                    elif isinstance(cause, ValueError):
                        # replica-side validation (e.g. max_tokens over the
                        # engine budget) crosses the actor boundary wrapped
                        # in TaskError: still the client's 400, not a 500
                        self._error(400, str(cause), "invalid_request_error")
                    else:
                        self._error(500, repr(e), "internal_error")

        self._server = EgresslessHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="openai-http",
        )
        self._thread.start()

    # ------------------------------------------------------------ translate

    def _handle_for(self, model_id: str):
        if model_id not in self.models:
            raise KeyError(model_id)
        return serve_api.get_handle(self.models[model_id])

    @staticmethod
    def _to_payload(req: Dict[str, Any], chat: bool) -> Dict[str, Any]:
        if chat:
            messages = req.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ValueError("'messages' must be a non-empty list")
            prompt_tokens = ByteTokenizer.encode(_chat_prompt(messages))
        else:
            prompt = req.get("prompt")
            if isinstance(prompt, str):
                prompt_tokens = ByteTokenizer.encode(prompt)
            elif isinstance(prompt, list) and all(
                isinstance(t, int) for t in prompt
            ):
                prompt_tokens = prompt  # OpenAI's token-array form
            else:
                raise ValueError("'prompt' must be a string or token list")
        payload: Dict[str, Any] = {
            "prompt_tokens": prompt_tokens,
            "max_tokens": int(req.get("max_tokens", 16)),
            "temperature": float(req.get("temperature", 1.0)),
        }
        if "top_p" in req:
            payload["top_p"] = float(req["top_p"])
        if "stop_token_ids" in req:
            payload["stop_token_ids"] = list(req["stop_token_ids"])
        stop = req.get("stop")
        if isinstance(stop, str):
            stop = [stop]
        if isinstance(stop, list):
            # single-byte stop strings map onto stop_token_ids; longer
            # ones ship as token sequences the engine matches over the
            # decoded tail (engine.py _hit_stop_sequence)
            for item in stop:
                ids = ByteTokenizer.encode(str(item))
                if not ids:
                    continue
                if len(ids) == 1:
                    payload.setdefault("stop_token_ids", []).append(ids[0])
                else:
                    payload.setdefault("stop_sequences", []).append(ids)
        return payload

    @staticmethod
    def _stop_strings(req: Dict[str, Any]) -> List[str]:
        stop = req.get("stop")
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list):
            return []
        return [str(s) for s in stop if str(s)]

    @staticmethod
    def _truncate_at_stop(text: str, stops: List[str]):
        """OpenAI semantics: the stop sequence itself is never returned.
        Returns (text up to the earliest stop occurrence, hit?)."""
        cut = None
        for s in stops:
            i = text.find(s)
            if i >= 0 and (cut is None or i < cut):
                cut = i
        if cut is None:
            return text, False
        return text[:cut], True

    def _completions(self, http, req: Dict[str, Any], chat: bool) -> None:
        from ... import api as core_api

        model_id = req.get("model") or next(iter(self.models))
        handle = self._handle_for(model_id)
        # `timeout_s` (our extension to the OpenAI schema) sets the
        # request's end-to-end deadline; cfg.serve_default_timeout_s
        # applies when absent. Expiry surfaces as HTTP 504.
        if "timeout_s" in req:
            handle = handle.options(timeout_s=float(req["timeout_s"]))
        # tenant context: the tenant header (cfg.serve_tenant_header) or
        # a registered API key resolves the caller; it rides the handle
        # into the engine's fair queue / quota bucket
        from .. import tenancy

        tenant, priority = tenancy.resolve_http_tenant(http.headers)
        if tenant is not None or priority is not None:
            handle = handle.options(tenant=tenant, priority=priority)
        request_id = getattr(http, "_request_id", None)
        if request_id:
            handle = handle.options(request_id=request_id)
        payload = self._to_payload(req, chat)
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        created = int(time.time())
        obj = "chat.completion" if chat else "text_completion"

        stops = self._stop_strings(req)
        if req.get("stream"):
            self._stream_sse(http, handle, payload, rid, created, model_id,
                             chat, stops)
            return
        result = core_api.get(handle.generate.remote(payload), timeout=300)
        text = ByteTokenizer.decode(result["tokens"])
        text, stopped = self._truncate_at_stop(text, stops)
        finish = (
            "length"
            if not stopped
            and result["usage"]["completion_tokens"] >= payload["max_tokens"]
            else "stop"
        )
        choice: Dict[str, Any] = {"index": 0, "finish_reason": finish,
                                  "logprobs": None}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        http._json(200, {
            "id": rid, "object": obj, "created": created, "model": model_id,
            "choices": [choice], "usage": result["usage"],
            "request_id": request_id,
        })

    def _stream_sse(self, http, handle, payload, rid, created, model_id,
                    chat, stops: Optional[List[str]] = None) -> None:
        """Server-sent events, OpenAI stream shape: one chunk per token,
        a final usage-bearing chunk, then `data: [DONE]`.

        Stop strings are enforced here too: decoded text that could be
        the prefix of a stop string is held back until it either
        completes the stop (dropped, stream finishes with
        finish_reason="stop") or diverges (flushed)."""
        from ... import api as core_api

        obj = "chat.completion.chunk" if chat else "text_completion"
        stream = handle.options(stream=True).stream_generate.remote(payload)
        http.send_response(200)
        http.send_header("Content-Type", "text/event-stream")
        http.send_header("Cache-Control", "no-cache")
        http.send_header("Transfer-Encoding", "chunked")
        rid_hdr = getattr(http, "_request_id", None)
        if rid_hdr:
            http.send_header("x-request-id", rid_hdr)
        http.end_headers()

        def send(data: str) -> None:
            write_chunk(http.wfile, f"data: {data}\n\n".encode())

        def chunk_body(choice: Dict[str, Any], usage=None) -> str:
            body = {
                "id": rid, "object": obj, "created": created,
                "model": model_id, "choices": [choice],
            }
            if usage is not None:
                body["usage"] = usage
            return json.dumps(body)

        import codecs

        # incremental decode: a multi-byte UTF-8 character split across
        # byte-tokens must not degrade to U+FFFD per byte — buffer until
        # the sequence completes, exactly like the non-streamed decode
        decoder = codecs.getincrementaldecoder("utf-8")("replace")
        stops = stops or []
        buf = ""  # decoded text held back as a possible stop prefix
        stopped = False

        def holdback(text: str) -> int:
            """Longest suffix of `text` that is a proper prefix of some
            stop string (must be withheld until it resolves)."""
            hold = 0
            for s in stops:
                for k in range(min(len(s) - 1, len(text)), hold, -1):
                    if text.endswith(s[:k]):
                        hold = k
                        break
            return hold

        def text_choice(text: str) -> Dict[str, Any]:
            if chat:
                return {"index": 0, "finish_reason": None,
                        "delta": {"content": text}}
            return {"index": 0, "finish_reason": None,
                    "logprobs": None, "text": text}

        try:
            for ref in stream:
                item = core_api.get(ref, timeout=300)
                if "token" in item:
                    tok = item["token"]
                    if stopped or not 0 <= tok < 256:
                        continue  # same contract as ByteTokenizer.decode
                    piece = decoder.decode(bytes([tok]))
                    if not piece:
                        continue  # mid-sequence: held back
                    buf += piece
                    buf, hit = self._truncate_at_stop(buf, stops)
                    if hit:
                        stopped = True
                        hold = 0
                    else:
                        hold = holdback(buf)
                    emit_now = buf[: len(buf) - hold] if hold else buf
                    buf = buf[len(buf) - hold:] if hold else ""
                    if emit_now:
                        send(chunk_body(text_choice(emit_now)))
                elif item.get("done"):
                    tail = "" if stopped else decoder.decode(b"", final=True)
                    # held-back text before a stop still ships; the stop
                    # string itself never does
                    tail, hit = self._truncate_at_stop(buf + tail, stops)
                    stopped = stopped or hit
                    usage = item.get("usage") or {}
                    finish = (
                        "stop" if stopped else (
                            "length"
                            if usage.get("completion_tokens", 0)
                            >= payload["max_tokens"] else "stop"
                        )
                    )
                    final = {"index": 0, "finish_reason": finish}
                    if chat:
                        final["delta"] = (
                            {"content": tail} if tail else {}
                        )
                    else:
                        final["text"] = tail
                        final["logprobs"] = None
                    send(chunk_body(final, usage=item.get("usage")))
        except Exception as e:  # noqa: BLE001 - surfaces as an SSE error event
            mapped = _http_status_for(e)
            etype = mapped[1] if mapped is not None else "internal_error"
            send(json.dumps({"error": {"message": repr(unwrap_error(e)),
                                       "type": etype}}))
        send("[DONE]")
        http.wfile.write(b"0\r\n\r\n")

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def build_openai_app(
    models: Optional[Dict[str, Any]] = None,
    *,
    model: Any = "gpt2-tiny",
    paged: bool = True,
    max_slots: int = 8,
    num_replicas: int = 1,
    tensor_parallel: int = 1,
    device: str = "cuda",
):
    """Build LLM app(s) and return them with the route table (model id →
    deployment name), not yet deployed. `models` maps model ids to model
    names/configs; `model` is the one-model form. Run with
    `serve_openai(...)` or serve.run + OpenAIFrontend. Each replica runs
    on `device` (build_llm_app raises without a CUDA device unless
    device="cpu")."""
    from .server import build_llm_app

    specs = models or {str(model): model}
    routes: Dict[str, str] = {}
    apps = []
    for model_id, m in specs.items():
        name = f"openai-{model_id}".replace("/", "-")
        apps.append(build_llm_app(
            m, name=name, num_replicas=num_replicas, max_slots=max_slots,
            paged=paged, tensor_parallel=tensor_parallel, device=device,
        ))
        routes[model_id] = name
    return apps, routes


def serve_openai(
    models: Optional[Dict[str, Any]] = None,
    *,
    model: Any = "gpt2-tiny",
    host: str = "127.0.0.1",
    port: int = 0,
    **build_kwargs,
) -> OpenAIFrontend:
    """One-call OpenAI endpoint: deploy the app(s) and serve /v1/* on
    `port`. Returns the frontend (``.port``, ``.stop()``)."""
    apps, routes = build_openai_app(models, model=model, **build_kwargs)
    for app, name in zip(apps, routes.values()):
        serve_api.run(app, name=name)
    return OpenAIFrontend(routes, host=host, port=port)
