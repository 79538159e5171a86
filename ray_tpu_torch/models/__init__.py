"""ray_tpu_torch.models — the decoder-only LM families (GPT-2, Llama), the
MoE transformer (Mixtral) and ViT / CLIP."""

from .configs import PRESETS, get_config  # noqa: F401
from .convert import params_from_numpy  # noqa: F401
from .moe import (  # noqa: F401
    MoEConfig,
    mixtral_8x7b,
    moe_loss,
    moe_tiny,
)
from .transformer import (  # noqa: F401
    TransformerConfig,
    count_params,
    decode_step,
    forward,
    forward_hidden,
    init_cache,
    init_params,
    lm_head_weights,
    logical_axes,
    prefill,
)
from .vit import (  # noqa: F401
    CLIPConfig,
    ViTConfig,
    clip_forward,
    clip_loss,
    clip_tiny,
    init_clip_params,
    vit_b16,
    vit_l16,
    vit_tiny,
)
