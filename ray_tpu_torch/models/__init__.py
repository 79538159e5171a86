"""ray_tpu_torch.models — the decoder-only LM families (GPT-2, Llama)."""

from .configs import PRESETS, get_config  # noqa: F401
from .convert import params_from_numpy  # noqa: F401
from .transformer import (  # noqa: F401
    TransformerConfig,
    count_params,
    decode_step,
    forward,
    forward_hidden,
    init_cache,
    init_params,
    lm_head_weights,
    prefill,
)
