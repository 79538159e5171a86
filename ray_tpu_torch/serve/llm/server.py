"""LLM server: the serve-facing wrapper around an engine.

Port of `LLMServer` from `ray_tpu/serve/llm/server.py`. `engine_config`
selects the engine, as in the JAX package: a `PagedEngineConfig` builds
the paged engine (paged KV pool, chunked prefill, the pipelined passes);
None or an `EngineConfig` builds the dense slot-grid `LLMEngine`.
Token-id interface: the payload carries `prompt_tokens`, and text
encode/decode is the caller's concern. The runtime deployment
(`build_llm_app`) and tensor parallelism are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ..._device import resolve_device
from ...models import get_config, init_params
from ...models.transformer import TransformerConfig
from ..context import (
    get_request_deadline,
    get_request_id,
    get_request_priority,
    get_request_tenant,
)
from .engine import EngineConfig, LLMEngine
from .paged_engine import PagedEngineConfig, PagedLLMEngine


class LLMServer:
    """Hosts one engine (one model replica) on one device."""

    def __init__(
        self,
        model: Union[str, TransformerConfig] = "gpt2-tiny",
        params: Any = None,
        engine_config: Optional[Union[EngineConfig, PagedEngineConfig]] = None,
        seed: int = 0,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        dev = resolve_device(device)
        config = get_config(model) if isinstance(model, str) else model
        if params is None:
            params = init_params(config, seed, device=dev)
        self.model_config = config
        if isinstance(engine_config, PagedEngineConfig):
            self.engine = PagedLLMEngine(config, params, engine_config, device=dev)
        else:
            self.engine = LLMEngine(config, params, engine_config, device=dev)

    def _submit(self, payload: Dict[str, Any]):
        """One place parses the payload for both entry points. The ambient
        request context (`serve/context.py`: deadline, id, tenant,
        priority) comes first; the payload's fields are the fallback for
        direct callers."""
        prompt = payload["prompt_tokens"]
        kwargs: Dict[str, Any] = {"deadline_ts": get_request_deadline()}
        request_id = get_request_id() or payload.get("request_id")
        if request_id:
            kwargs["request_id"] = str(request_id)
        tenant = get_request_tenant() or payload.get("tenant")
        if tenant:
            kwargs["tenant"] = str(tenant)
        priority = get_request_priority()
        if priority is None and "priority" in payload:
            priority = int(payload["priority"])
        if priority is not None:
            kwargs["priority"] = int(priority)
        for name, cast in (("top_k", int), ("top_p", float),
                           ("stop_token_ids", list),
                           ("stop_sequences", list)):
            if name in payload:
                kwargs[name] = cast(payload[name])
        stream = self.engine.submit(
            prompt,
            int(payload.get("max_tokens", 64)),
            float(payload.get("temperature", 0.0)),
            **kwargs,
        )
        return prompt, stream

    @staticmethod
    def _usage(prompt, n: int) -> Dict[str, int]:
        return {
            "prompt_tokens": len(prompt),
            "completion_tokens": n,
            "total_tokens": len(prompt) + n,
        }

    def generate(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """{"prompt_tokens": [...], "max_tokens": n, "temperature": t} →
        {"tokens": [...], "usage": {...}, "ttft_s": s, "request_id": id}."""
        prompt, stream = self._submit(payload)
        tokens = stream.result()
        return {
            "tokens": tokens,
            "usage": self._usage(prompt, len(tokens)),
            "ttft_s": stream.ttft_s,
            "request_id": stream.request_id,
        }

    def stream_generate(self, payload: Dict[str, Any]):
        """Token-streaming variant: yields one {"token": id} per generated
        token as the engine produces it, then a final {"done": true,
        "usage": ..., "ttft_s": s, "request_id": id}."""
        prompt, stream = self._submit(payload)
        n = 0
        for token in stream:
            n += 1
            yield {"token": token}
        yield {"done": True, "usage": self._usage(prompt, n), "ttft_s": stream.ttft_s,
               "request_id": stream.request_id}

    def metrics(self, _payload: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """A copy of the engine's metrics dict."""
        return dict(self.engine.metrics)

    def check_health(self) -> None:
        """Raise when the engine loop has died (an error on the card, a
        failed read) or was shut down."""
        if not self.engine._thread.is_alive():
            raise RuntimeError("engine loop died") from self.engine._death_cause

    def shutdown(self) -> None:
        self.engine.shutdown()
