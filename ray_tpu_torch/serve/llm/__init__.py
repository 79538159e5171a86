"""ray_tpu_torch.serve.llm — continuous-batching LLM serving: the dense
slot-grid engine and the paged engine."""

from .engine import EngineConfig, LLMEngine  # noqa: F401
from .paged import PagedConfig  # noqa: F401
from .paged_engine import PagedEngineConfig, PagedLLMEngine  # noqa: F401
from .server import LLMServer  # noqa: F401
