"""Model family presets (port of `ray_tpu/models/configs.py`).

Sizes follow the published architectures; `*_tiny` variants are shrunk
for tests.
"""

from __future__ import annotations

import torch

from .transformer import TransformerConfig


def gpt2_small() -> TransformerConfig:
    """GPT-2 124M."""
    return TransformerConfig(
        vocab_size=50257,
        d_model=768,
        n_layers=12,
        n_heads=12,
        d_ff=3072,
        max_seq=1024,
        pos_emb="learned",
        norm="layernorm",
        act="gelu",
        use_bias=True,
        tie_embeddings=True,
    )


def gpt2_medium() -> TransformerConfig:
    return gpt2_small().replace(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)


def gpt2_xl() -> TransformerConfig:
    return gpt2_small().replace(d_model=1600, n_layers=48, n_heads=25, d_ff=6400)


def llama3_8b() -> TransformerConfig:
    """Llama-3-8B."""
    return TransformerConfig(
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        max_seq=8192,
        pos_emb="rope",
        norm="rmsnorm",
        act="swiglu",
        use_bias=False,
        tie_embeddings=False,
        rope_theta=500000.0,
        remat=True,
    )


def llama3_70b() -> TransformerConfig:
    return llama3_8b().replace(
        d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8, d_ff=28672
    )


def gpt2_tiny() -> TransformerConfig:
    """4-layer GPT-2 for tests."""
    return TransformerConfig(
        vocab_size=256,
        d_model=64,
        n_layers=4,
        n_heads=4,
        d_ff=128,
        max_seq=128,
        pos_emb="learned",
        norm="layernorm",
        act="gelu",
        use_bias=True,
        tie_embeddings=True,
        dtype=torch.float32,
    )


def llama_tiny() -> TransformerConfig:
    """4-layer Llama-style (rope/rmsnorm/swiglu/GQA) for tests."""
    return TransformerConfig(
        vocab_size=256,
        d_model=64,
        n_layers=4,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        max_seq=128,
        pos_emb="rope",
        norm="rmsnorm",
        act="swiglu",
        use_bias=False,
        tie_embeddings=False,
        dtype=torch.float32,
    )


PRESETS = {
    "gpt2-small": gpt2_small,
    "gpt2-medium": gpt2_medium,
    "gpt2-xl": gpt2_xl,
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "gpt2-tiny": gpt2_tiny,
    "llama-tiny": llama_tiny,
}


def get_config(name: str) -> TransformerConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}") from None
