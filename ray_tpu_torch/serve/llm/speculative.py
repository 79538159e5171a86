"""Speculative decoding for the paged engine: draft, verify, accept.

Port of `ray_tpu/serve/llm/speculative.py`. A DRAFT proposer guesses the
next tokens of a lane on the host; the engine scores the pending token and
every draft in one verify round (a q_len = 1 + drafts region of the mixed
pass's ragged launch), and an exact accept/resample step keeps the output
distribution that of plain decoding:

- temperature 0: accept drafts while they match the verified argmax; the
  first mismatch emits the argmax instead (the plain engine's tokens).
- temperature > 0: rejection sampling against the verified (temperature /
  top-k / top-p filtered) distribution. The proposers are deterministic
  (point-mass q), so draft t is accepted with probability p(t), and a
  rejection resamples from p with t masked out and renormalized.

A round emits between 1 (every draft rejected: the corrected token) and
K+1 (every draft accepted plus the bonus token from the last verified row)
tokens. The accept step's random draws come from an explicit
`torch.Generator`, so the engine's CUDA graphs can register it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Protocol, Sequence, Tuple

import torch


class DraftProposer(Protocol):
    """Propose up to `k` draft tokens continuing `context` (prompt plus
    every token emitted so far). Returning fewer than `k` (or none) is
    always legal: the verify round shrinks to what was proposed."""

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ...


class NgramProposer:
    """Prompt-lookup self-drafting: find the longest recent n-gram suffix
    of the context earlier in the context and propose the tokens that
    followed it. No model and no device; empty proposals (a plain 1-token
    round) on novel text."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if max_ngram < min_ngram or min_ngram < 1:
            raise ValueError(f"bad ngram range [{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        if k <= 0:
            return []
        ctx = list(context)
        for n in range(min(self.max_ngram, len(ctx) - 1), self.min_ngram - 1, -1):
            needle = ctx[-n:]
            # newest match first: recent repetition predicts best
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] == needle:
                    cont = ctx[i + n:i + n + k]
                    if cont:
                        return cont
        return []


class ReplayProposer:
    """Drill proposer: replays known continuations keyed by prompt.
    Replaying a previous greedy run's outputs makes every draft accept (the
    high-acceptance drill); replaying corrupted outputs makes every draft
    reject (the rollback drill)."""

    def __init__(self, continuations: Dict[Tuple[int, ...], Sequence[int]]):
        self._cont = {tuple(p): list(c) for p, c in continuations.items()}
        self._lens = sorted({len(p) for p in self._cont}, reverse=True)

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        for plen in self._lens:
            cont = self._cont.get(tuple(ctx[:plen]))
            if cont is None:
                continue
            done = len(ctx) - plen  # tokens already emitted
            if done < 0 or ctx[plen:] != cont[:done]:
                continue  # diverged from the recorded run: stop drafting
            return cont[done:done + k]
        return []


class DraftModelProposer:
    """Greedy K-token draft from a small dense model on the engine's device.

    Recomputes the full window per drafted token (K `prefill` passes over
    a fixed `window`-token buffer, whose attention is the flash forward
    kernel on the card); the tokens stay on the device until the one host
    read of the K drafts at the end. That read is this opt-in proposer's
    output: the engine pays a round trip per verify round anyway."""

    def __init__(self, model_config: Any, params: Any, window: int = 64):
        self.window = int(window)
        self.model_config = model_config
        self._params = params
        self._device = params["wte"].device

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        from ...models.transformer import init_cache, prefill

        if k <= 0:
            return []
        mc = self.model_config
        tail = list(context)[-(self.window - k):]
        buf = torch.zeros((1, self.window), dtype=torch.int64)
        buf[0, : len(tail)] = torch.tensor(tail, dtype=torch.int64)
        buf = buf.to(self._device)
        toks = []
        with torch.no_grad():
            for j in range(k):
                n = len(tail) + j
                cache = init_cache(mc, 1, self.window, device=self._device)
                lengths = torch.full((1,), n, dtype=torch.int64, device=self._device)
                logits, _ = prefill(self._params, buf, lengths, cache, mc)
                nxt = torch.argmax(logits[0])
                buf[0, n] = nxt
                toks.append(nxt)
        return [int(t) for t in torch.stack(toks).tolist()]


# ------------------------------------------------------------ accept step


def filtered_scores(
    logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor, top_ps: torch.Tensor
) -> torch.Tensor:
    """Per-lane temperature + top-k + top-p filtered scores (log-space;
    filtered-out tokens at -inf). POSITIONAL filtering over one sort:
    exactly top_k tokens survive even under logit ties, and the nucleus
    keep-mask scatters back through the sort order (disabled lanes use
    k=V / p=1.0, which keep all). softmax of the result is the exact
    distribution `_sample_filtered` draws from, and the one the accept
    step scores drafts against."""
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


def categorical(scores: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(scores), by the Gumbel-max
    construction jax.random.categorical uses (the bits differ: the
    generator is torch's)."""
    u = torch.rand(scores.shape, generator=generator, device=scores.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)


def accept_speculative(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    counts: torch.Tensor,
    generator: torch.Generator,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact accept/resample over one verify round. Reads nothing back to
    the host, so a CUDA graph can capture it.

    logits: (B, K, V) verified logits; row j scores the token AFTER input
        row j (inputs are `tokens`: row 0 the pending token, rows 1..K-1
        the drafts).
    tokens: (B, K) integer verify inputs.
    counts: (B,) real input rows per lane (0 = inactive).
    Returns (out_tokens (B, K) int64, n_out (B,) int64): lane b emits
    out_tokens[b, :n_out[b]], its accepted drafts followed by the corrected
    (on rejection) or bonus (all accepted) token; n_out >= 1 for active
    lanes.
    """
    b, kd, vocab = logits.shape
    dev = logits.device
    tokens, counts = tokens.long(), counts.long()
    per_row = [t[:, None].expand(b, kd).reshape(-1) for t in (temps, top_ks, top_ps)]
    flat = filtered_scores(logits.reshape(b * kd, vocab), *per_row)
    scores = flat.reshape(b, kd, vocab)
    greedy = torch.argmax(logits, dim=-1)  # (B, K): the plain samplers' argmax at t=0
    drafts = tokens[:, 1:]  # (B, K-1): draft j+1 is scored by logits row j
    if kd > 1:
        probs = torch.softmax(scores[:, :-1], dim=-1)
        p_draft = torch.gather(probs, -1, drafts[..., None])[..., 0]  # (B, K-1)
        u = torch.rand((b, kd - 1), generator=generator, device=dev)
        accept = torch.where(temps[:, None] <= 0.0, drafts == greedy[:, :-1], u < p_draft)
        # draft j+1 only exists (and only verifies) inside the real rows
        accept &= torch.arange(kd - 1, device=dev)[None, :] < (counts[:, None] - 1)
        a = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # accepted drafts per lane
    else:
        a = torch.zeros((b,), dtype=torch.int64, device=dev)
    lane = torch.arange(b, device=dev)
    # correction / bonus from verified row a: on rejection the rejected
    # draft is masked out of row a's distribution (the point-mass
    # residual); when every draft was accepted, row a == counts-1 and the
    # full distribution yields the bonus token
    row_scores = scores[lane, a]  # (B, V)
    rejected = tokens[lane, torch.clamp(a + 1, max=kd - 1)]
    bonus = a >= (counts - 1)
    hit = torch.arange(vocab, device=dev)[None, :] == rejected[:, None]
    resid = torch.where(hit & ~bonus[:, None], -torch.inf, row_scores)
    next_tok = torch.where(temps <= 0.0, greedy[lane, a], categorical(resid, generator))
    idx = torch.arange(kd, device=dev)[None, :]
    draft_shift = torch.cat([drafts, torch.zeros((b, 1), dtype=torch.int64, device=dev)], dim=1)
    out = torch.where(idx < a[:, None], draft_shift,
                      torch.where(idx == a[:, None], next_tok[:, None], 0))
    n_out = torch.where(counts > 0, a + 1, 0)
    return out, n_out
