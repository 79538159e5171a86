"""LLM deployment: the serve-facing wrapper around an engine, and the app
builder.

Port of `ray_tpu/serve/llm/server.py`. `engine_config` selects the
engine, as in the JAX package: a `PagedEngineConfig` builds the paged
engine (paged KV pool, chunked prefill, the pipelined passes); None or an
`EngineConfig` builds the dense slot-grid `LLMEngine`. Token-id
interface: the payload carries `prompt_tokens`, and text encode/decode is
the caller's concern. `build_llm_app` binds LLMServer into a serve
deployment (`serve.run(build_llm_app(...))`). `tensor_parallel=n > 1`
shards the paged engine over a tp mesh of the first n devices of the
server's device type, as JAX's takes `jax.devices()[:n]`: n CPU devices
on the CPU; on CUDA, n distinct cards, which raise NotImplementedError
until ROADMAP A4 (TP serving across cards). One card runs a tp engine
whose shards share it through `PagedLLMEngine(mesh=build_mesh(
MeshSpec(tp=n), ["cuda:0"] * n))`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from ..._device import resolve_device
from ...models import get_config, init_params
from ...models.transformer import TransformerConfig
from ...parallel.mesh import MeshSpec, build_mesh
from ..deployment import Application, deployment
from ..context import (
    get_request_deadline,
    get_request_id,
    get_request_priority,
    get_request_tenant,
)
from .engine import EngineConfig, LLMEngine
from .paged_engine import PagedEngineConfig, PagedLLMEngine


class LLMServer:
    """Hosts one engine (one model replica) on one device, or on a tp
    mesh of `tensor_parallel` devices (the paged engine only). `params`
    is held by reference: replicas built from one weight tree share its
    tensors."""

    def __init__(
        self,
        model: Union[str, TransformerConfig] = "gpt2-tiny",
        params: Any = None,
        engine_config: Optional[Union[EngineConfig, PagedEngineConfig]] = None,
        seed: int = 0,
        tensor_parallel: int = 1,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        dev = resolve_device(device)
        mesh = None
        if tensor_parallel > 1:
            mesh = build_mesh(MeshSpec(tp=tensor_parallel),
                              devices=_first_devices(dev, tensor_parallel))
        config = get_config(model) if isinstance(model, str) else model
        if params is None:
            params = init_params(config, seed, device=dev)
        self.model_config = config
        if isinstance(engine_config, PagedEngineConfig):
            self.engine = PagedLLMEngine(config, params, engine_config, mesh=mesh,
                                         device=None if mesh is not None else dev)
        else:
            if mesh is not None:
                raise ValueError(
                    "tensor_parallel requires the paged engine "
                    "(engine_config=PagedEngineConfig(...))"
                )
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

    def __ray_shutdown__(self) -> None:
        """The replica actor holding this server stopped: stop the engine
        and drop it, so its caches and graphs are freed even while a
        reference to the server outlives the replica."""
        self.engine.shutdown()
        del self.engine

    def __del__(self):
        # a server dropped without shutdown() stops its engine's threads,
        # so the engine's caches and graphs can go with it
        try:
            self.engine.shutdown()
        except Exception:
            pass


def _first_devices(device: torch.device, n: int) -> List[str]:
    """The first n devices of `device`'s type (JAX's `jax.devices()[:n]`):
    the CPU n times; n CUDA devices, of which there must be as many."""
    if device.type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count()
    if count < n:
        raise ValueError(f"tensor_parallel={n} wants {n} CUDA devices; this machine has {count}")
    return [f"cuda:{i}" for i in range(n)]


def build_llm_app(
    model: Union[str, TransformerConfig] = "gpt2-tiny",
    *,
    name: str = "llm",
    num_replicas: int = 1,
    max_slots: int = 8,
    params: Any = None,
    paged: bool = False,
    tensor_parallel: int = 1,
    device: Union[str, torch.device] = "cuda",
) -> Application:
    """OpenAI-compatible app builder: LLMServer as a deployment of
    `num_replicas` replicas, each with `2 x max_slots` concurrent calls.
    paged=True builds the paged engine (`PagedEngineConfig(max_slots)`),
    the default the dense `LLMEngine` (`EngineConfig(max_slots)`), as in
    the JAX package. `params` (a weight tree on `device`) is shared by
    reference between the replicas; None makes each replica draw its own
    from seed 0. Replicas run on `device`: the CUDA device by default,
    which must exist (this raises without one unless device="cpu").
    tensor_parallel > 1 shards each replica's paged engine over a tp mesh
    (`LLMServer`)."""
    resolve_device(device)
    if tensor_parallel > 1 and not paged:
        raise ValueError("tensor_parallel requires paged=True")
    dep = deployment(
        LLMServer, name=name, num_replicas=num_replicas, max_ongoing_requests=max_slots * 2
    )
    engine_config = (
        PagedEngineConfig(max_slots=max_slots) if paged
        else EngineConfig(max_slots=max_slots)
    )
    return dep.bind(model, params, engine_config, 0, tensor_parallel, device=device)
