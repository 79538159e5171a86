"""ViT image encoder + CLIP dual tower.

Port of `ray_tpu/models/vit.py`. The encoder is the decoder's block stack
(`transformer._block`) with `causal=False`, so its attention runs the
flash kernels non-causal on the card (ViT-B/16: S 197, D 64); patchify is
a reshape and one matrix product, as in JAX. CLIP's text tower is causal.
Parameters are plain dicts in JAX's layout; `models.convert.
params_from_numpy` carries JAX's trees (nested for CLIP) key for key.
`remat=True` runs each block under `torch.utils.checkpoint` while
gradients are recorded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops import cross_entropy_loss
from .transformer import (
    Params,
    TransformerConfig,
    _block,
    _norm,
    init_params as _dense_init,
    logical_axes as _dense_axes,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    out_dim: int = 1000  # classes (classifier) or projection dim (CLIP)
    pool: str = "cls"  # "cls" | "mean"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def encoder_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1,  # unused: the tower has no token embedding
            d_model=self.d_model,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            d_ff=self.d_ff,
            max_seq=self.num_patches + 1,
            pos_emb="learned",
            norm="layernorm",
            act="gelu",
            use_bias=True,
            causal=False,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            remat=self.remat,
        )

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


def vit_b16() -> ViTConfig:
    return ViTConfig()


def vit_l16() -> ViTConfig:
    return ViTConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)


def vit_tiny() -> ViTConfig:
    return ViTConfig(
        image_size=32,
        patch_size=8,
        d_model=64,
        n_layers=2,
        n_heads=4,
        d_ff=128,
        out_dim=10,
        dtype=torch.float32,
    )


# ----------------------------------------------------------------------- init


def _generator(seed: int, dev: torch.device, generator: Optional[torch.Generator]):
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return generator


def init_params(
    config: ViTConfig,
    seed: int = 0,
    *,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> Params:
    """The encoder's blocks and final norm as the transformer draws them,
    the patch projection at N(0, 1 / patch_dim), the class token, learned
    positions and head at N(0, 0.02), zero biases (JAX's distributions,
    another generator's bits)."""
    c = config
    dev = resolve_device(device)
    generator = _generator(seed, dev, generator)
    base = _dense_init(c.encoder_config, device=dev, generator=generator)
    pd = c.param_dtype
    patch_dim = c.patch_size * c.patch_size * c.channels

    def normal(shape, s):
        return torch.empty(shape, dtype=pd, device=dev).normal_(0.0, s, generator=generator)

    return {
        "patch_proj": normal((patch_dim, c.d_model), 1.0 / math.sqrt(patch_dim)),
        "patch_bias": torch.zeros((c.d_model,), dtype=pd, device=dev),
        "cls": normal((1, 1, c.d_model), 0.02),
        "pos": normal((c.num_patches + 1, c.d_model), 0.02),
        "blocks": base["blocks"],
        "lnf_scale": base["lnf_scale"],
        "lnf_bias": base["lnf_bias"],
        "head": normal((c.d_model, c.out_dim), 0.02),
        "head_bias": torch.zeros((c.out_dim,), dtype=pd, device=dev),
    }


def logical_axes(config: ViTConfig) -> Params:
    base = _dense_axes(config.encoder_config)
    return {
        "patch_proj": (None, "embed"),
        "patch_bias": (None,),
        "cls": (None, None, "embed"),
        "pos": (None, "embed"),
        "blocks": base["blocks"],
        "lnf_scale": (None,),
        "lnf_bias": (None,),
        "head": ("embed", None),
        "head_bias": (None,),
    }


# -------------------------------------------------------------------- forward


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C), row-major patches."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _run_blocks(x: torch.Tensor, blocks: Params, config: TransformerConfig) -> torch.Tensor:
    """The stacked blocks over x, each under checkpoint when the config
    remats and gradients are recorded."""
    remat = config.remat and torch.is_grad_enabled()
    for i in range(config.n_layers):
        lp = {name: w[i] for name, w in blocks.items()}
        if remat:
            x = checkpoint(_block, x, lp, config, None, None, use_reentrant=False)
        else:
            x = _block(x, lp, config, None, None)
    return x


def forward(params: Params, images: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) float images -> (B, out_dim)."""
    c = config
    dt = c.dtype
    patches = patchify(images.to(dt), c.patch_size)
    x = patches @ params["patch_proj"].to(dt)
    x = x + params["patch_bias"].to(dt)
    cls = params["cls"].to(dt).expand(x.shape[0], 1, c.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos"].to(dt)[None]
    x = _run_blocks(x, params["blocks"], c.encoder_config)
    x = _norm(x, params["lnf_scale"], params["lnf_bias"], "layernorm")
    pooled = x[:, 0] if c.pool == "cls" else x[:, 1:].mean(dim=1)
    return pooled @ params["head"].to(dt) + params["head_bias"].to(dt)


# ----------------------------------------------------------------------- CLIP


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: ViTConfig = dataclasses.field(default_factory=vit_b16)
    text: TransformerConfig = dataclasses.field(
        default_factory=lambda: TransformerConfig(
            vocab_size=49408,
            d_model=512,
            n_layers=12,
            n_heads=8,
            d_ff=2048,
            max_seq=77,
            pos_emb="learned",
            norm="layernorm",
            act="gelu",
            causal=True,
            tie_embeddings=False,
        )
    )
    proj_dim: int = 512
    init_logit_scale: float = math.log(1 / 0.07)


def clip_tiny() -> CLIPConfig:
    return CLIPConfig(
        vision=vit_tiny().replace(out_dim=32),
        text=TransformerConfig(
            vocab_size=256,
            d_model=64,
            n_layers=2,
            n_heads=4,
            d_ff=128,
            max_seq=16,
            pos_emb="learned",
            norm="layernorm",
            act="gelu",
            causal=True,
            tie_embeddings=False,
            dtype=torch.float32,
        ),
        proj_dim=32,
    )


def init_clip_params(
    config: CLIPConfig,
    seed: int = 0,
    *,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> Params:
    """The vision tower (out_dim = proj_dim), the text trunk without its LM
    head, the text projection at N(0, 0.02) and the logit scale."""
    dev = resolve_device(device)
    generator = _generator(seed, dev, generator)
    vision = init_params(config.vision.replace(out_dim=config.proj_dim), device=dev,
                         generator=generator)
    text = _dense_init(config.text, device=dev, generator=generator)
    text.pop("lm_head", None)
    proj = torch.empty((config.text.d_model, config.proj_dim), dtype=config.text.param_dtype,
                       device=dev).normal_(0.0, 0.02, generator=generator)
    return {
        "vision": vision,
        "text": text,
        "text_proj": proj,
        "logit_scale": torch.tensor(config.init_logit_scale, dtype=torch.float32, device=dev),
    }


def _text_features(params: Params, tokens: torch.Tensor, lengths: torch.Tensor,
                   config: CLIPConfig) -> torch.Tensor:
    """Causal text tower pooled at the last valid token."""
    c = config.text
    dt = c.dtype
    s = tokens.shape[1]
    x = params["wte"][tokens.long()].to(dt)
    x = x + params["wpe"].to(dt)[None, :s]
    x = _run_blocks(x, params["blocks"], c.replace(remat=False))
    x = _norm(x, params["lnf_scale"], params.get("lnf_bias"), c.norm)
    return x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1]


def clip_forward(params: Params, images: torch.Tensor, tokens: torch.Tensor,
                 lengths: torch.Tensor, config: CLIPConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (image_emb (B,P), text_emb (B,P), logit_scale), L2-normalised."""
    vision_cfg = config.vision.replace(out_dim=config.proj_dim)
    img = forward(params["vision"], images, vision_cfg).float()
    txt = _text_features(params["text"], tokens, lengths, config).float()
    txt = txt @ params["text_proj"].float()
    img = img / (torch.linalg.norm(img, dim=-1, keepdim=True) + 1e-8)
    txt = txt / (torch.linalg.norm(txt, dim=-1, keepdim=True) + 1e-8)
    scale = torch.exp(torch.clamp(params["logit_scale"], -10.0, math.log(100.0)))
    return img, txt, scale


def clip_loss(params: Params, images: torch.Tensor, tokens: torch.Tensor,
              lengths: torch.Tensor, config: CLIPConfig) -> torch.Tensor:
    """Symmetric InfoNCE over the batch."""
    img, txt, scale = clip_forward(params, images, tokens, lengths, config)
    logits = scale * img @ txt.T  # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    li, _ = cross_entropy_loss(logits, labels)
    lt, _ = cross_entropy_loss(logits.T, labels)
    return 0.5 * (li + lt)
