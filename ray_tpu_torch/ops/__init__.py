"""ray_tpu_torch.ops — CUDA kernels for Hopper with plain PyTorch paths.

Port of `ray_tpu.ops`. The attention functions dispatch by device: a CUDA
tensor launches the hand-written kernel under `csrc/`, a CPU tensor takes
the plain PyTorch version kept beside it. `KERNELS` lists every kernel, for
building them together and reading their launch counts.
"""

from .attention import (  # noqa: F401
    FLASH_FWD,
    flash_attention,
    flash_attention_with_lse,
    mha_reference,
)
from .layers import (  # noqa: F401
    apply_rope,
    gelu,
    layernorm,
    rmsnorm,
    rope_frequencies,
    swiglu,
)
from .ragged_paged_attention import (  # noqa: F401
    RAGGED,
    ragged_paged_attention,
    ragged_reference_attention,
)

KERNELS = (RAGGED, FLASH_FWD)
