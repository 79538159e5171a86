"""ray_tpu_torch.serve.llm — continuous-batching LLM serving: the dense
slot-grid engine, the paged engine, LLMServer and its app builder, and the
OpenAI-compatible frontend."""

from .engine import EngineConfig, LLMEngine  # noqa: F401
from .openai import ByteTokenizer, OpenAIFrontend, build_openai_app, serve_openai  # noqa: F401
from .paged import PagedConfig  # noqa: F401
from .paged_engine import PagedEngineConfig, PagedLLMEngine  # noqa: F401
from .server import LLMServer, build_llm_app  # noqa: F401
