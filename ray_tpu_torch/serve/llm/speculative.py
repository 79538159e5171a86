"""Filtered sampling scores (port of `filtered_scores` from
`ray_tpu/serve/llm/speculative.py`; the draft proposers and the verify
accept step are not ported yet)."""

from __future__ import annotations

import torch


def filtered_scores(
    logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor, top_ps: torch.Tensor
) -> torch.Tensor:
    """Per-lane temperature + top-k + top-p filtered scores (log-space;
    filtered-out tokens at -inf). POSITIONAL filtering over one sort:
    exactly top_k tokens survive even under logit ties, and the nucleus
    keep-mask scatters back through the sort order (disabled lanes use
    k=V / p=1.0, which keep all). softmax of the result is the exact
    distribution `_sample_filtered` draws from."""
    b, vocab = logits.shape
    scaled = logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
    # descending order as the reversed stable ascending sort, like the JAX code
    order = torch.argsort(scaled, dim=-1, stable=True).flip(-1)
    desc = torch.gather(scaled, -1, order)
    k_idx = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, vocab))
    positions = torch.arange(vocab, device=logits.device)[None, :]
    in_topk = positions < k_idx[:, None]
    p_desc = torch.softmax(torch.where(in_topk, desc, -torch.inf), dim=-1)
    cum = torch.cumsum(p_desc, dim=-1)
    # keep a token if the cumulative mass BEFORE it is < top_p
    # (the top token always survives: cum - p == 0 there)
    keep_sorted = in_topk & ((cum - p_desc) < top_ps.float()[:, None])
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, scaled, -torch.inf)
