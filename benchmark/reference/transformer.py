"""The plain reference of the decoder the benchmark runs: GPT-2 and the
Llama / Mistral family, written from the published architectures in plain
PyTorch, float32, with TF32 off. It imports nothing of the program: it
reads the benchmark's own weight tree (the layout the port takes, made by
`harness/weights.py`) and works out everything else itself.

- Mistral-7B: token embedding; per layer RMSNorm, q / k / v projections
  (grouped-query: 32 query heads over 8 key-value heads), rotary
  embedding in the split-half convention (theta from the configuration),
  causal softmax attention, output projection, residual; RMSNorm and a
  SwiGLU MLP (silu(x W_gate) * (x W_up)) W_down, residual; a final RMSNorm
  and an untied head. One departure from the published model, noted in
  its configuration file: RMSNorm's epsilon is the port's 1e-6, not 1e-5.
- GPT-2: token and learned position embeddings; LayerNorm (eps 1e-5),
  attention with biases, the tanh-approximated GELU MLP with biases; a
  final LayerNorm and the head tied to the token embedding.

`precision="fp8"` is the control: every matrix product's operands are
rounded to float8 (e4m3 forward, e5m2 for gradients in the backward),
each tensor scaled by its own absolute maximum, as fp8 inference and
training recipes do; everything else as above. It stands in for a
program that computes below the bfloat16 its configuration states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 products in float32, not TF32, for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def round_fp8(x: torch.Tensor, fmt: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to float8 `fmt` with a per-tensor scale, back in x's dtype."""
    top = E4M3_MAX if fmt == torch.float8_e4m3fn else E5M2_MAX
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / top
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:  # a weight: the gradient sums over every leading axis of a
            gb = qa.reshape(-1, qa.shape[-1]).transpose(0, 1) @ qg.reshape(-1, qg.shape[-1])
        else:  # batched operands (attention's products)
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., K) @ b (K, N), in float32 or through the fp8 control."""
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), positions (S,): split-half rotary embedding."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block: int = 1024,
              precision: str = "f32") -> torch.Tensor:
    """Causal attention over one sequence: q (S, Hq, D), k / v (S, Hkv, D)
    -> (S, Hq, D); grouped heads share their key-value head. Queries go
    in blocks of `block` rows to bound the score matrix."""
    s, hq, d = q.shape
    g = hq // k.shape[1]
    kh = k.repeat_interleave(g, dim=1).transpose(0, 1)  # (Hq, S, D)
    vh = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    out = []
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        scores = matmul(qh[:, i0:i1], kh[:, :i1].transpose(1, 2), precision) / math.sqrt(d)
        mask = torch.arange(i1, device=q.device)[None, :] <= torch.arange(i0, i1, device=q.device)[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        out.append(matmul(torch.softmax(scores, dim=-1), vh[:, :i1], precision))
    return torch.cat(out, dim=1).transpose(0, 1)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], m: Dict[str, Any], positions: torch.Tensor,
          precision: str = "f32") -> torch.Tensor:
    """One decoder block on x (S, E) with its weights `w` (this layer's
    slices, float32)."""
    s, e = x.shape
    hq = m["n_heads"]
    hkv = m.get("n_kv_heads") or hq
    d = e // hq
    if m["norm"] == "rmsnorm":
        h = rmsnorm(x, w["ln1_scale"], m["norm_eps"])
    else:
        h = layernorm(x, w["ln1_scale"], w["ln1_bias"], m["norm_eps"])
    q = matmul(h, w["wq"].reshape(e, hq * d), precision).view(s, hq, d)
    k = matmul(h, w["wk"].reshape(e, hkv * d), precision).view(s, hkv, d)
    v = matmul(h, w["wv"].reshape(e, hkv * d), precision).view(s, hkv, d)
    if m["use_bias"]:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    if m["pos_emb"] == "rope":
        q, k = rope(q, positions, m["rope_theta"]), rope(k, positions, m["rope_theta"])
    a = attention(q, k, v, precision=precision).reshape(s, hq * d)
    o = matmul(a, w["wo"].reshape(hq * d, e), precision)
    if m["use_bias"]:
        o = o + w["bo"]
    x = x + o
    if m["norm"] == "rmsnorm":
        h = rmsnorm(x, w["ln2_scale"], m["norm_eps"])
    else:
        h = layernorm(x, w["ln2_scale"], w["ln2_bias"], m["norm_eps"])
    up = matmul(h, w["w_up"], precision)
    if m["use_bias"]:
        up = up + w["b_up"]
    if m["act"] == "swiglu":
        act = F.silu(matmul(h, w["w_gate"], precision)) * up
    else:
        act = F.gelu(up, approximate="tanh")
    down = matmul(act, w["w_down"], precision)
    if m["use_bias"]:
        down = down + w["b_down"]
    return x + down


def layer_weights(tree: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    return {k: _f32(v[i]) for k, v in tree["blocks"].items()}


def embed(tree: Dict[str, Any], m: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    x = _f32(tree["wte"])[tokens]
    if m["pos_emb"] == "learned":
        x = x + _f32(tree["wpe"])[: tokens.shape[0]]
    return x


def final_hidden(tree: Dict[str, Any], m: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if m["norm"] == "rmsnorm":
        return rmsnorm(x, _f32(tree["lnf_scale"]), m["norm_eps"])
    return layernorm(x, _f32(tree["lnf_scale"]), _f32(tree["lnf_bias"]), m["norm_eps"])


def head(tree: Dict[str, Any]) -> torch.Tensor:
    """(E, V) output projection: the untied head or the token embedding's
    transpose."""
    return _f32(tree["lm_head"]) if "lm_head" in tree else _f32(tree["wte"]).T


@torch.no_grad()
def logits_at(tree: Dict[str, Any], m: Dict[str, Any], tokens: Sequence[int],
              rows: Sequence[int], precision: str = "f32") -> torch.Tensor:
    """The logits (len(rows), V), float32, at positions `rows` of one
    sequence `tokens`, layer by layer (each layer's weights in float32
    only while it runs)."""
    dev = tree["wte"].device
    with no_tf32():
        t = torch.tensor(list(tokens), dtype=torch.long, device=dev)
        positions = torch.arange(t.shape[0], device=dev)
        x = embed(tree, m, t)
        for i in range(m["n_layers"]):
            x = layer(x, layer_weights(tree, i), m, positions, precision)
        h = final_hidden(tree, m, x[torch.as_tensor(list(rows), device=dev)])
        return matmul(h, head(tree), precision)


def greedy_gaps(tree: Dict[str, Any], m: Dict[str, Any], prompt: List[int], served: List[int],
                control: bool = False) -> Dict[str, float]:
    """How far below the reference's best logit each served token's logit
    lies, over the served positions of one request: {"max", "sum", "n"}.
    With `control`, the tokens judged are those the fp8 control puts first
    at each position (same prompt and served prefix), not the served ones."""
    seq = list(prompt) + list(served[:-1])
    rows = list(range(len(prompt) - 1, len(seq)))
    ref = logits_at(tree, m, seq, rows)
    if control:
        picked = logits_at(tree, m, seq, rows, precision="fp8").argmax(-1)
    else:
        picked = torch.tensor(served, device=ref.device)
    gap = ref.max(-1).values - ref.gather(-1, picked[:, None])[:, 0]
    return {"max": float(gap.max()), "sum": float(gap.sum()), "n": len(rows)}


def sequence_loss(tree: Dict[str, Any], m: Dict[str, Any], row: torch.Tensor,
                  precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross entropy of one (S + 1,) row: inputs row[:-1],
    targets row[1:], through the whole model (differentiable in `tree`)."""
    inputs, targets = row[:-1], row[1:]
    positions = torch.arange(inputs.shape[0], device=row.device)
    x = embed(tree, m, inputs)
    for i in range(m["n_layers"]):
        x = layer(x, {k: v[i] for k, v in tree["blocks"].items()}, m, positions, precision)
    logits = matmul(final_hidden(tree, m, x), head(tree), precision)
    return F.cross_entropy(logits, targets)


def flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflat(leaves: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in leaves.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def forward_all(tree: Dict[str, Any], m: Dict[str, Any], tokens: torch.Tensor,
                precision: str = "f32") -> torch.Tensor:
    """Full-sequence logits (S, V) of one sequence (for tests)."""
    with no_tf32(), torch.no_grad():
        positions = torch.arange(tokens.shape[0], device=tokens.device)
        x = embed(tree, m, tokens)
        for i in range(m["n_layers"]):
            x = layer(x, layer_weights(tree, i), m, positions, precision)
        return matmul(final_hidden(tree, m, x), head(tree), precision)
