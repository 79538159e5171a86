"""ray_tpu_torch.serve.llm — paged continuous-batching LLM serving."""

from .paged import PagedConfig  # noqa: F401
from .paged_engine import PagedEngineConfig, PagedLLMEngine  # noqa: F401
from .server import LLMServer  # noqa: F401
