"""Traffic generators: one per `kind` of traffic file, each reading only the
file's parameters and the run's seed.

Every seed gets the same work. Sizes are the distribution's quantiles at
(k + 0.5) / n and arrival gaps the exponential's, so two seeds send the
same multiset of lengths at the same multiset of gaps, in another order,
with other token ids: the seed changes what is computed, not how much.
That keeps runs of different seeds as close as runs of one seed.

- `open_loop`: independent users. Requests are due on a schedule over the
  window, whether earlier ones have finished or not (Poisson gaps at
  `rate_per_s`), each with a prompt and an output length; optionally a
  shared system prompt (one of `prefixes.count`, page-aligned, chosen by a
  Zipf law) before a user turn; with `warm_prefixes` set-up serves each
  system prompt once, so the window sees a deployment's steady state with
  the prompts cached, not its cold start.
- `backlog`: offline batch work, a closed loop. `depth` requests are in
  the system from the window's start and each one that finishes is
  replaced at once from a seeded stream (`Backlog`).
- `train_batches`: documents of lognormal length, tokens uniform over the
  vocabulary, an end-of-text token between documents, packed into rows
  of `seq + 1` tokens (inputs and shifted targets), `batch` rows a step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

SEED_MIX = 0x9E3779B9  # keeps the traffic's streams apart from the weights'


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of one seed (any seed up to 2**63)."""
    return np.random.default_rng([int(seed) & (2**63 - 1), stream, SEED_MIX])


def quantiles(spec: Dict[str, Any], n: int) -> np.ndarray:
    """n sizes: the distribution's quantiles at (k + 0.5) / n, clipped to
    [min, max] and rounded. `spec` is {"dist": "lognormal", "median",
    "sigma", "min", "max"} or {"dist": "uniform", "min", "max"}."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        values = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        values = spec["min"] + u * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(np.rint(values), spec["min"], spec["max"]).astype(np.int64)


@dataclasses.dataclass
class Request:
    """One request of a serving schedule. `due` is seconds after the
    window's start (open loop) or None (backlog: sent when a slot of the
    backlog frees)."""

    index: int
    prompt: List[int]
    max_tokens: int
    due: Optional[float] = None
    prefix_id: int = -1  # the shared system prompt it starts with, if any


def _ids(gen: np.random.Generator, n: int, vocab: int) -> List[int]:
    return gen.integers(0, vocab, n).tolist()


def prefixes(params: Dict[str, Any], seed: int, vocab: int) -> List[List[int]]:
    """The mix's shared system prompts (none without `prefixes`)."""
    spec = params.get("prefixes")
    if not spec:
        return []
    gen = rng(seed, 3)
    return [_ids(gen, int(spec["tokens"]), vocab) for _ in range(int(spec["count"]))]


def _zipf_choices(spec: Dict[str, Any], n: int, gen: np.random.Generator) -> np.ndarray:
    """n prefix indices with P(i) ~ 1 / (i + 1)^s, as a fixed multiset
    (each index gets its expected share, largest remainders first) in a
    seeded order."""
    k, s = int(spec["count"]), float(spec["zipf_s"])
    p = 1.0 / np.arange(1, k + 1) ** s
    p /= p.sum()
    counts = np.floor(p * n).astype(int)
    rest = np.argsort(-(p * n - counts))[: n - counts.sum()]
    counts[rest] += 1
    choices = np.repeat(np.arange(k), counts)
    gen.shuffle(choices)
    return choices


def open_loop(params: Dict[str, Any], seed: int, seconds: float, vocab: int) -> List[Request]:
    """The schedule of an open-loop window of `seconds`: n = round(rate x
    seconds) requests whose gaps are the exponential's quantiles in a
    seeded order, scaled so the gaps sum to the window."""
    n = max(1, int(round(float(params["rate_per_s"]) * seconds)))
    gen = rng(seed, 1)
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    gen.shuffle(gaps)
    gaps *= seconds / gaps.sum()
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    outputs = quantiles(params["output"], n)
    gen.shuffle(outputs)
    shared = prefixes(params, seed, vocab)
    ids = rng(seed, 2)
    out: List[Request] = []
    if shared:
        turns = quantiles(params["user_turn"], n)
        gen.shuffle(turns)
        which = _zipf_choices(params["prefixes"], n, gen)
        for i in range(n):
            prompt = shared[which[i]] + _ids(ids, int(turns[i]), vocab)
            out.append(Request(i, prompt, int(outputs[i]), float(due[i]), int(which[i])))
        return out
    prompts = quantiles(params["prompt"], n)
    gen.shuffle(prompts)
    for i in range(n):
        out.append(Request(i, _ids(ids, int(prompts[i]), vocab), int(outputs[i]), float(due[i])))
    return out


class Backlog:
    """A backlog's seeded stream of requests. Sizes come in blocks of
    `block` (each block one multiset of quantiles, in a seeded order), so
    any seed's first n requests carry nearly the same work."""

    def __init__(self, params: Dict[str, Any], seed: int, vocab: int):
        self.params = params
        self.block = int(params.get("block", 256))
        self.vocab = vocab
        self.gen = rng(seed, 1)
        self.ids = rng(seed, 2)
        self.count = 0
        self._sizes: List = []

    def next(self) -> Request:
        if not self._sizes:
            prompts = quantiles(self.params["prompt"], self.block)
            outputs = quantiles(self.params["output"], self.block)
            self.gen.shuffle(prompts)
            self.gen.shuffle(outputs)
            self._sizes = list(zip(prompts.tolist(), outputs.tolist()))[::-1]
        p, o = self._sizes.pop()
        req = Request(self.count, _ids(self.ids, int(p), self.vocab), int(o))
        self.count += 1
        return req


def max_request_tokens(params: Dict[str, Any]) -> int:
    """The longest prompt + output a mix can send (to size the engine's
    slots against)."""
    if params["kind"] == "open_loop" and params.get("prefixes"):
        prompt = int(params["prefixes"]["tokens"]) + int(params["user_turn"]["max"])
    else:
        prompt = int(params["prompt"]["max"])
    return prompt + int(params["output"]["max"])


class PackedBatches:
    """Packed pre-training batches from one seed: documents of lognormal
    length (`doc` spec, tokens), ids uniform over [0, vocab) without the
    end-of-text id, which separates documents. Each batch is a
    (batch, seq + 1) int64 numpy array; documents run across rows and
    batches, as a packed corpus does, and no two rows repeat."""

    def __init__(self, params: Dict[str, Any], seed: int, vocab: int):
        self.batch = int(params["batch"])
        self.row = int(params["seq"]) + 1
        self.eot = int(params["eot_id"])
        self.vocab = vocab
        self.spec = params["doc"]
        self.gen = rng(seed, 4)
        self.docs = 0
        self._buf = np.empty(0, dtype=np.int64)
        self._lengths = quantiles(self.spec, int(params.get("doc_block", 4096)))

    def _doc(self) -> np.ndarray:
        if self.docs % len(self._lengths) == 0:
            self.gen.shuffle(self._lengths)
        n = int(self._lengths[self.docs % len(self._lengths)])
        self.docs += 1
        ids = self.gen.integers(0, self.vocab - 1, n, dtype=np.int64)
        ids[ids >= self.eot] += 1  # uniform over the vocabulary without the eot id
        return np.concatenate([ids, [self.eot]])

    def next(self) -> np.ndarray:
        need = self.batch * self.row
        parts = [self._buf]
        have = len(self._buf)
        while have < need:
            d = self._doc()
            parts.append(d)
            have += len(d)
        flat = np.concatenate(parts)
        self._buf = flat[need:]
        return flat[:need].reshape(self.batch, self.row)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()
