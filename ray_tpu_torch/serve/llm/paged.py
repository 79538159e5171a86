"""Paged KV cache + chunked prefill: the continuous-batching substrate.

Port of `ray_tpu/serve/llm/paged.py`:

- the KV cache is one FLAT pool of pages, (Hkv, L*num_pages, page_size, D)
  — layer i owns page range [i*num_pages, (i+1)*num_pages) — shared by
  every slot; a host-side allocator hands out (layer-agnostic) page ids
  and a per-slot block table maps logical positions to pages;
- attention reads ONLY the pages a slot uses, through the ragged paged
  attention kernel (`ops.ragged_paged_attention`) on the card and its
  plain version on the CPU;
- prefill is CHUNKED: prompts are ingested page-aligned chunk by chunk;
- a refcounted allocator and a page-level PREFIX CACHE let requests that
  share a page-aligned prompt prefix reuse its KV pages, and `copy_page`
  is the device half of copy-on-write.

Page 0 is reserved as a scratch page: idle lanes and pad rows write there
and block-table rows default to it.

The device passes are plain PyTorch; the engine runs each as a CUDA graph
on the card (`graphs.py`) and eagerly on the CPU. Where the JAX passes
thread the pool through chains of dynamic_update_slice (so XLA can alias
the donated buffer), these write the pool IN PLACE with indexed
assignment and return the same dict. `rope_tables` takes the (cos, sin)
tables an engine computes once (JAX's jit folds them into constants);
without it a pass computes them itself.

TENSOR PARALLELISM (`mesh=`, a single-controller tp mesh): JAX runs the
passes as one SPMD program under `serving_shardings` and lets XLA insert
the collectives; here the pass loops over the shards, in one process.
`params` is then the list of the shards' parameter trees
(`paged_engine.place_params`) and `cache` the list of their pools
(`init_paged_cache(mesh=)`: kv heads split, (Hkv/tp, L*P, ps, D) each).
Layer by layer each shard computes q, k and v for its heads, writes its
pool and launches the ragged kernel on it; the output projection and the
MLP's down projection are row-parallel, so the shards' partial sums are
added (`_tp_sum`, in shard order: the all-reduce, whose result every
shard holds; the replicated activations are kept once). A split
vocabulary is embedded by masked lookups summed over the shards and
projected by each shard's head columns, concatenated before sampling.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..._device import resolve_device
from ...models.transformer import (
    TransformerConfig,
    _norm,
    embed,
    layer_params,
    lm_head_weights,
    mlp_products,
    mlp_sublayer,
)
from ...ops import apply_rope, ragged_paged_attention, rope_frequencies
from ...parallel.spmd import vocab_rows

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    page_size: int = 64
    num_pages: int = 256          # pool size (page 0 reserved as scratch)
    max_pages_per_slot: int = 16  # static block-table width
    chunk_pages: int = 4          # prefill chunk = chunk_pages * page_size
    # Prefix/KV-cache reuse (PrefixCache): requests sharing a page-aligned
    # prompt prefix reuse its KV instead of re-prefilling. Off by default:
    # retired prompts then PIN their pages (the cache holds a ref) until
    # pool pressure evicts them.
    prefix_cache: bool = False
    prefix_cache_pages: int = 0   # max cached pages; 0 = pool pressure only

    @property
    def chunk_tokens(self) -> int:
        return self.chunk_pages * self.page_size

    @property
    def max_slot_tokens(self) -> int:
        return self.max_pages_per_slot * self.page_size


def init_paged_cache(
    model: TransformerConfig,
    paged: PagedConfig,
    device: Union[str, torch.device] = "cuda",
    mesh: Any = None,
) -> Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]:
    """One FLAT page pool across layers: layer i owns pages
    [i*num_pages, (i+1)*num_pages), in the model's compute dtype. Under a
    tp mesh, one pool per shard on its device, holding its kv heads
    (the pool's kv-head axis split, as `serving_shardings` lays it out)."""
    tp = _tp(mesh)
    if model.kv_heads % tp:
        raise ValueError(f"tp={tp} must divide kv_heads ({model.kv_heads})")
    shape = (
        model.kv_heads // tp,
        model.n_layers * paged.num_pages,
        paged.page_size,
        model.head_dim,
    )
    devices = [resolve_device(device)] if mesh is None or tp == 1 else mesh.devices
    pools = [{
        "k": torch.zeros(shape, dtype=model.dtype, device=dev),
        "v": torch.zeros(shape, dtype=model.dtype, device=dev),
    } for dev in devices]
    return pools if tp > 1 else pools[0]


def _tp(mesh: Any) -> int:
    return 1 if mesh is None else mesh.shape["tp"]


def _shards(params: Any, cache: Any, mesh: Any
            ) -> Tuple[List[Params], List[Dict[str, torch.Tensor]]]:
    """The tp shards' parameter trees and pools as lists: under a tp mesh
    the lists `place_params` and `init_paged_cache(mesh=)` give, else the
    one tree and pool."""
    tp = _tp(mesh)
    if tp == 1:
        return [params], [cache]
    if len(params) != tp or len(cache) != tp:
        raise ValueError(f"a tp={tp} pass takes {tp} shards' params and pools, got "
                         f"{len(params)} and {len(cache)}")
    return list(params), list(cache)


def _tp_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The shards' partial sums added in shard order: the all-reduce of a
    single-controller mesh, whose one result every shard holds."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _embed_shards(shards: List[Params], tokens: torch.Tensor, c: TransformerConfig) -> torch.Tensor:
    """Token embeddings in the compute dtype; a vocabulary split over the
    shards is looked up vocab-parallel (each shard's rows in its range,
    zeros elsewhere) and summed."""
    rows = shards[0]["wte"].shape[0]
    if rows == c.vocab_size:
        return embed(shards[0], tokens, c)
    return _tp_sum([vocab_rows(p["wte"], tokens, i * rows, c.dtype)
                    for i, p in enumerate(shards)])


def _head_logits(shards: List[Params], x: torch.Tensor, c: TransformerConfig) -> torch.Tensor:
    """x @ the LM head; a head split into vocabulary columns gives each
    shard's logits, concatenated in shard order."""
    heads = [lm_head_weights(p, c) for p in shards]
    if heads[0].shape[-1] == c.vocab_size:
        return x @ heads[0]
    return torch.cat([x @ head for head in heads], dim=-1)


def _mlp_shards(x: torch.Tensor, lps: List[Params], c: TransformerConfig) -> torch.Tensor:
    """`mlp_sublayer` over the shards' hidden units: each shard's
    products (`mlp_products`, column- then row-parallel), the partial
    sums added, then the bias and the residual."""
    h = _norm(x, lps[0]["ln2_scale"], lps[0].get("ln2_bias"), c.norm)
    down = _tp_sum([mlp_products(h, lp, c) for lp in lps])
    if c.use_bias:
        down = down + lps[0]["b_down"].to(c.dtype)
    return x + down


class PageAllocator:
    """Host-side REFCOUNTED free list over the page pool.

    With the prefix cache a physical page can back several block tables at
    once (slots sharing a prompt prefix, plus the cache's own pin), so
    ownership is a count: `alloc` hands out pages at refcount 1, `share`
    adds a holder, and `free` drops one; a page returns to the free list
    only when its LAST holder lets go. Page 0 is the scratch page: never
    handed out, never counted, and `free` / `share` ignore it."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._lock = threading.Lock()

    def alloc(self, n: int) -> Optional[List[int]]:
        with self._lock:
            if len(self._free) < n:
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one holder to each page. Sharing a page that is not
        allocated raises: resurrecting a freed page would corrupt the slot
        the free list hands it to next."""
        with self._lock:
            for p in pages:
                if p <= 0:
                    continue
                if p not in self._refs:
                    raise ValueError(f"share of unallocated page {p}")
                self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        # Drop ONE holder per page. A page with no live holder is ignored,
        # so a buggy caller can never put the same physical page on the
        # free list twice (which would hand it to two slots).
        with self._lock:
            for p in pages:
                if p > 0 and p in self._refs:
                    self._refs[p] -= 1
                    if self._refs[p] <= 0:
                        del self._refs[p]
                        self._free.append(p)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)


# ---------------------------------------------------------------- prefix cache


def _chain_hash(prev: bytes, chunk: Sequence[int]) -> bytes:
    """Chain hash of page-aligned token chunks. A page's KV is a function
    of every token up to the page's end (causal attention), so keying page
    p by H(H(...), tokens of page p) makes a hit sufficient for reuse.
    blake2b, not python's hash(): a collision would splice one prompt's KV
    into another request."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(chunk, dtype=np.int64).tobytes())
    return h.digest()


class PrefixCache:
    """Refcounted page-level prefix cache over the allocator.

    Maps the chain hash of each page a prompt fully covers to the physical
    page holding its KV. The cache holds ONE reference per entry (the pin
    that keeps a finished request's prompt pages warm); every slot that
    reuses a page takes its own through `allocator.share`. Eviction (LRU,
    and only of pages whose sole holder is the cache) is driven by pool
    pressure: the engine calls `evict` when an alloc fails, so cached
    prefixes never starve admissions."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 capacity_pages: int = 0):
        self.allocator = allocator
        self.page_size = page_size
        self.capacity_pages = capacity_pages  # 0 = bounded by pool pressure only
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, prompt: Sequence[int]) -> List[int]:
        """Longest cached page-aligned prefix of `prompt`, capped so at
        least one prompt token is left to prefill (its logits seed
        sampling). Matched pages get one reference taken FOR THE CALLER,
        who releases them through the refcounted free path."""
        ps = self.page_size
        max_reuse = max(0, (len(prompt) - 1) // ps)
        matched: List[int] = []
        digest = b""
        with self._lock:
            for p in range(max_reuse):
                digest = _chain_hash(digest, prompt[p * ps:(p + 1) * ps])
                page = self._entries.get(digest)
                if page is None:
                    break
                matched.append(page)
                self._entries.move_to_end(digest)
            self.hits += len(matched)
            self.misses += max_reuse - len(matched)
        if matched:
            self.allocator.share(matched)
        return matched

    def register(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Publish every page `prompt` fully covers (KV already written by
        this slot's prefill). The cache takes its own reference per NEW
        entry; hashes already present keep their page. Returns the number
        of pages newly published."""
        ps = self.page_size
        full = len(prompt) // ps
        added = 0
        with self._lock:
            digest = b""
            for p in range(full):
                digest = _chain_hash(digest, prompt[p * ps:(p + 1) * ps])
                if digest in self._entries:
                    self._entries.move_to_end(digest)
                    continue
                if (
                    self.capacity_pages > 0
                    and len(self._entries) >= self.capacity_pages
                    and not self._evict_locked(1)
                ):
                    break
                page = pages[p]
                self.allocator.share([page])
                self._entries[digest] = page
                self._entries.move_to_end(digest)
                added += 1
        return added

    def evict(self, n: int) -> int:
        """Release up to n cache-pinned pages toward the pool (LRU first,
        skipping pages live slots still hold)."""
        with self._lock:
            return self._evict_locked(n)

    def _evict_locked(self, n: int) -> int:
        dropped = 0
        for digest, page in list(self._entries.items()):
            if dropped >= n:
                break
            if self.allocator.refcount(page) != 1:
                continue  # held by a live slot: survives the sweep
            del self._entries[digest]
            self.allocator.free([page])
            self.evictions += 1
            dropped += 1
        return dropped

    def stats(self) -> Dict[str, float]:
        with self._lock:
            hits, misses = self.hits, self.misses
            return {
                "hits": float(hits),
                "misses": float(misses),
                "evictions": float(self.evictions),
                "pages": float(len(self._entries)),
                "hit_rate": hits / max(1, hits + misses),
            }

    def chain_heads(self, limit: int = 64) -> List[Dict[str, Any]]:
        """MRU-first view of the cached entries: each row one published
        page keyed by its chain-hash head, with its live refcount (1 =
        pinned only by the cache, >1 = shared by slots)."""
        with self._lock:
            rows = [
                {"digest": digest.hex(), "page": page}
                for digest, page in reversed(self._entries.items())
            ][:limit]
        for row in rows:
            row["refcount"] = self.allocator.refcount(row["page"])
        return rows


# ------------------------------------------------------------------ attention


def _gather_ref_attention(q, k_cache, v_cache, block_tables, lengths):
    """Plain paged decode attention (the semantic ground truth of
    `paged_attention`). q (B, Hq, D); caches (Hkv, P, ps, D); block_tables
    (B, maxP); lengths (B,). Returns (B, Hq, D)."""
    b, hq, d = q.shape
    hkv = k_cache.shape[0]
    k = k_cache[:, block_tables.long()].transpose(0, 1).reshape(b, hkv, -1, d)
    v = v_cache[:, block_tables.long()].transpose(0, 1).reshape(b, hkv, -1, d)
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=1)
        v = torch.repeat_interleave(v, hq // hkv, dim=1)
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) / math.sqrt(d)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < lengths.long()[:, None]
    logits = torch.where(mask[:, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs.to(v.dtype), v)


def paged_attention(q, k_cache, v_cache, block_tables, lengths, *, page_size: int,
                    mesh: Any = None):
    """Decode-step paged attention: the q_len == 1 case of the ragged
    kernel. Each (B, Hq, D) lane becomes one block_q-row region whose real
    row is row 0. Under a tp mesh each shard runs its head group
    (`ragged_paged_attention(mesh=)`)."""
    b, hq, head_dim = q.shape
    block_q = 8
    q_r = torch.zeros((hq, b, block_q, head_dim), dtype=q.dtype, device=q.device)
    q_r[:, :, 0] = q.transpose(0, 1)
    ones = torch.ones((b,), dtype=torch.int32, device=q.device)
    out = ragged_paged_attention(
        q_r.reshape(hq, b * block_q, head_dim), k_cache, v_cache,
        torch.arange(b, dtype=torch.int32, device=q.device), ones, ones,
        lengths.to(torch.int32), block_tables.to(torch.int32),
        block_q=block_q, max_q_blocks=1, mesh=mesh,
    )
    return out.reshape(hq, b, block_q, head_dim)[:, :, 0].transpose(0, 1)  # (B, Hq, D)


# --------------------------------------------------------------- model passes


def _token_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'te,ehd->htd' as one matrix product: (T, E) @ (E, H, D) -> (H, T, D)."""
    t, e = h.shape
    return (h @ w.reshape(e, -1)).view(t, w.shape[1], w.shape[2]).transpose(0, 1)


def batched_chunk_prefill_step(
    params: Params,
    cache: Dict[str, torch.Tensor],
    page_rows: torch.Tensor,       # (B, maxP) block tables of the batched slots
    chunk_page_ids: torch.Tensor,  # (B, chunk_pages) pages each chunk fills
    tokens: torch.Tensor,          # (B, C) chunks, right-padded
    offsets: torch.Tensor,         # (B,) tokens already ingested (page-aligned)
    total_lens: torch.Tensor,      # (B,) offset + real tokens this chunk
    config: TransformerConfig,
    *,
    page_size: int,
    rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ingest one prompt chunk for up to B slots in one pass, attending
    through a dense gather of each lane's pages (plain PyTorch, as the JAX
    pass is plain XLA). Inactive lanes point their chunk_page_ids at the
    scratch page (0) with total_len 0. Returns the LAST real token's logits
    per lane (B, V) and the pool, updated in place."""
    c = config
    dt = c.dtype
    b, chunk = tokens.shape
    chunk_pages = chunk // page_size
    dev = tokens.device
    offsets, total_lens = offsets.long(), total_lens.long()
    pos = offsets[:, None] + torch.arange(chunk, device=dev)[None, :]  # (B, C)
    x = embed(params, tokens, c)  # (B, C, E)
    table_pos = torch.clamp(pos, 0, c.max_seq - 1)  # clamped like XLA's gathers
    if c.pos_emb == "learned":
        x = x + params["wpe"][table_pos].to(dt)
        rope_tables = None
    elif rope_tables is None:
        rope_tables = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=dev)
    flat_ids = chunk_page_ids.reshape(-1).long()  # (B*cp,) — scratch dups are fine

    k_full, v_full = cache["k"], cache["v"]
    num_pages = k_full.shape[1] // c.n_layers
    key_pos = torch.arange(page_rows.shape[1] * page_size, device=dev)
    causal = key_pos[None, None, :] <= pos[:, :, None]           # (B, C, S)
    valid = key_pos[None, None, :] < total_lens[:, None, None]
    attn_mask = (causal & valid)[:, None]
    for i in range(c.n_layers):
        lp = layer_params(params, i)
        h = _norm(x, lp["ln1_scale"], lp.get("ln1_bias"), c.norm)
        e = h.shape[-1]
        q = (h @ lp["wq"].to(dt).reshape(e, -1)).view(b, chunk, c.n_heads, -1).transpose(1, 2)
        k = (h @ lp["wk"].to(dt).reshape(e, -1)).view(b, chunk, c.kv_heads, -1).transpose(1, 2)
        v = (h @ lp["wv"].to(dt).reshape(e, -1)).view(b, chunk, c.kv_heads, -1).transpose(1, 2)
        if c.use_bias:
            q = q + lp["bq"].to(dt)[None, :, None, :]
            k = k + lp["bk"].to(dt)[None, :, None, :]
            v = v + lp["bv"].to(dt)[None, :, None, :]
        if rope_tables is not None:
            cos, sin = rope_tables
            q = apply_rope(q, cos, sin, table_pos)
            k = apply_rope(k, cos, sin, table_pos)
        # whole-page in-place writes, (lane, chunk page) -> pool page
        hkv, d = k.shape[1], k.shape[-1]
        kp = k.transpose(0, 1).reshape(hkv, b * chunk_pages, page_size, d)
        vp = v.transpose(0, 1).reshape(hkv, b * chunk_pages, page_size, d)
        layer_flat = flat_ids + i * num_pages
        k_full[:, layer_flat] = kp.to(c.dtype)
        v_full[:, layer_flat] = vp.to(c.dtype)
        # per-lane gathered attention over each slot's own pages
        layer_rows = page_rows.long() + i * num_pages  # (B, maxP)
        keys = k_full[:, layer_rows].transpose(0, 1).reshape(b, hkv, -1, d)
        vals = v_full[:, layer_rows].transpose(0, 1).reshape(b, hkv, -1, d)
        if c.n_heads != hkv:
            keys = torch.repeat_interleave(keys, c.n_heads // hkv, dim=1)
            vals = torch.repeat_interleave(vals, c.n_heads // hkv, dim=1)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), keys.float()) / math.sqrt(d)
        logits = torch.where(attn_mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs.to(vals.dtype), vals)
        out = attn.to(dt).transpose(1, 2).reshape(b, chunk, -1) @ lp["wo"].to(dt).reshape(-1, c.d_model)
        if c.use_bias:
            out = out + lp["bo"].to(dt)
        x = mlp_sublayer(x + out, lp, c)
    x = _norm(x, params["lnf_scale"], params.get("lnf_bias"), c.norm)
    # vocab projection ONLY for each lane's last real token (B, E) @ (E, V)
    last = torch.clamp(total_lens - offsets - 1, 0, chunk - 1)
    x_last = x[torch.arange(b, device=dev), last]  # (B, E)
    return x_last @ lm_head_weights(params, c), cache


def chunk_prefill_step(
    params: Params,
    cache: Dict[str, torch.Tensor],
    page_row: torch.Tensor,        # (maxP,) this slot's block table
    chunk_page_ids: torch.Tensor,  # (chunk_pages,) pages this chunk fills
    tokens: torch.Tensor,          # (1, C) the chunk, right-padded
    offset: torch.Tensor,          # () tokens already ingested (page-aligned)
    total_len: torch.Tensor,       # () offset + real tokens in this chunk
    config: TransformerConfig,
    *,
    page_size: int,
    rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-slot chunk prefill: the B=1 case of
    batched_chunk_prefill_step (kept as the documented one-slot API).
    Returns the last real token's logits (1, V) and the pool, updated in
    place."""
    return batched_chunk_prefill_step(
        params, cache, page_row[None], chunk_page_ids[None], tokens,
        offset.reshape(1), total_len.reshape(1), config,
        page_size=page_size, rope_tables=rope_tables,
    )


def ragged_mixed_step(
    params: Params,
    cache: Dict[str, torch.Tensor],
    page_rows: torch.Tensor,       # (P+B, maxP) tables: prefill lanes then decode
    chunk_page_ids: torch.Tensor,  # (P, cp) pages each prefill chunk fills
    prefill_tokens: torch.Tensor,  # (P, C) chunks, right-padded
    offsets: torch.Tensor,         # (P,) tokens already ingested (page-aligned)
    totals: torch.Tensor,          # (P,) offset + real tokens (0 = inactive)
    dec_tokens: torch.Tensor,      # (B,) or (B, Kd) decode input tokens
    dec_positions: torch.Tensor,   # (B,) decode write positions (first token)
    dec_active: torch.Tensor,      # (B,) int32 real tokens this tick (0..Kd)
    config: TransformerConfig,
    *,
    page_size: int,
    block_q: int = 8,
    rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """ONE pass for a mixed tick: P prefill chunks AND B decode lanes run
    through a single token-major transformer pass whose attention is one
    ragged-paged-attention launch per layer.

    Token-major layout: T = P*C + B*R rows (R = ceil(Kd/block_q)*block_q).
    Prefill lane p owns rows [p*C, (p+1)*C); decode lane b owns the R-row
    region at P*C + b*R with its dec_active[b] real tokens at rows 0... The
    ragged descriptor (q_lens = chunk fill / count / 0, kv_lens = totals /
    position+count / 0) masks everything else off; pad rows write only to
    the scratch page.

    Returns (prefill last-token logits (P, V), decode logits — (B, V) for
    1-D dec_tokens, else (B, Kd, V) — and the pool, updated in place).
    Under a tp `mesh`, `params` and `cache` are the shards' (module
    docstring) and each shard launches the kernel once a layer.
    """
    shards, pools = _shards(params, cache, mesh)
    c = config
    dt = c.dtype
    dev = prefill_tokens.device
    p_lanes, chunk = prefill_tokens.shape
    squeeze_dec = dec_tokens.dim() == 1
    if squeeze_dec:
        dec_tokens = dec_tokens[:, None]
    b_lanes, dec_width = dec_tokens.shape
    chunk_pages = chunk // page_size
    if chunk % block_q:
        raise ValueError(f"chunk tokens ({chunk}) must divide by block_q "
                         f"({block_q})")
    dec_blocks = -(-dec_width // block_q)
    dec_region = dec_blocks * block_q  # rows per decode lane
    offsets, totals = offsets.long(), totals.long()
    dec_positions, dec_counts = dec_positions.long(), dec_active.long()
    i32 = torch.int32

    # ---- token-major embedding -------------------------------------------
    pre_pos = offsets[:, None] + torch.arange(chunk, device=dev)[None, :]      # (P, C)
    dec_pos_grid = dec_positions[:, None] + torch.arange(dec_width, device=dev)[None, :]
    dec_region_pos = torch.zeros((b_lanes, dec_region), dtype=torch.long, device=dev)
    dec_region_pos[:, :dec_width] = dec_pos_grid
    positions = torch.cat([pre_pos.reshape(-1), dec_region_pos.reshape(-1)])  # (T,)
    dec_region_tok = torch.zeros((b_lanes, dec_region), dtype=torch.long, device=dev)
    dec_region_tok[:, :dec_width] = dec_tokens
    tokens = torch.cat([prefill_tokens.reshape(-1).long(), dec_region_tok.reshape(-1)])
    x = _embed_shards(shards, tokens, c)  # (T, E)
    # pad rows may sit past max_seq: table lookups clamp, as XLA's gathers do
    rope_pos = torch.clamp(positions, 0, c.max_seq - 1)
    if c.pos_emb == "learned":
        x = x + shards[0]["wpe"][rope_pos].to(dt)
        rope_tables = None
    elif rope_tables is None:
        rope_tables = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=dev)

    # ---- ragged descriptor (static regions, dynamic lengths) -------------
    cb = chunk // block_q
    starts = torch.cat([
        torch.arange(p_lanes, device=dev) * cb,
        p_lanes * cb + torch.arange(b_lanes, device=dev) * dec_blocks,
    ]).to(i32)
    counts = torch.cat([
        torch.full((p_lanes,), cb, device=dev),
        torch.full((b_lanes,), dec_blocks, device=dev),
    ]).to(i32)
    q_lens = torch.cat([totals - offsets, dec_counts]).to(i32)
    kv_lens = torch.cat([totals, (dec_positions + dec_counts) * (dec_counts > 0)]).to(i32)

    flat_ids = chunk_page_ids.reshape(-1).long()  # (P*cp,)
    # per-(lane, token) page/row targets: token j of lane b lands at
    # position dec_positions[b] + j. Rows past dec_counts[b] go to the
    # scratch page — the gather index is clamped so a lane near max_pages
    # can't wrap, and the page is forced to 0 so a clamped gather can't
    # alias the lane's live KV.
    rows_l = page_rows.long()
    maxp = rows_l.shape[1]
    valid_tok = torch.arange(dec_width, device=dev)[None, :] < dec_counts[:, None]
    page_idx = torch.clamp(dec_pos_grid // page_size, 0, maxp - 1)
    gathered = rows_l[p_lanes + torch.arange(b_lanes, device=dev)[:, None], page_idx]
    dec_pages = torch.where(valid_tok, gathered, 0).reshape(-1)           # (B*Kd,)
    dec_rows = torch.where(valid_tok, dec_pos_grid % page_size, 0).reshape(-1)
    dec_src = (
        p_lanes * chunk
        + (torch.arange(b_lanes, device=dev) * dec_region)[:, None]
        + torch.arange(dec_width, device=dev)[None, :]
    ).reshape(-1)  # token rows of the decode inputs

    num_pages = pools[0]["k"].shape[1] // c.n_layers
    max_q_blocks = max(cb, dec_blocks)
    for i in range(c.n_layers):
        lps = [layer_params(p, i) for p in shards]
        h = _norm(x, lps[0]["ln1_scale"], lps[0].get("ln1_bias"), c.norm)
        table = (rows_l + i * num_pages).to(i32)
        parts = []
        for lp, pool in zip(lps, pools):
            k_full, v_full = pool["k"], pool["v"]
            # heads-leading token-major projections: (T, E) @ (E, H, D) -> (H, T, D)
            q = _token_heads(h, lp["wq"].to(dt))
            k = _token_heads(h, lp["wk"].to(dt))
            v = _token_heads(h, lp["wv"].to(dt))
            if c.use_bias:
                q = q + lp["bq"].to(dt)[:, None, :]
                k = k + lp["bk"].to(dt)[:, None, :]
                v = v + lp["bv"].to(dt)[:, None, :]
            if rope_tables is not None:
                cos, sin = rope_tables
                q = apply_rope(q[None], cos, sin, rope_pos[None])[0]
                k = apply_rope(k[None], cos, sin, rope_pos[None])[0]
            hkv, d = k.shape[0], k.shape[-1]
            # prefill KV: whole pages, (lane, chunk page) -> pool page
            layer_flat = flat_ids + i * num_pages
            k_full[:, layer_flat] = (
                k[:, : p_lanes * chunk].reshape(hkv, p_lanes * chunk_pages, page_size, d).to(c.dtype)
            )
            v_full[:, layer_flat] = (
                v[:, : p_lanes * chunk].reshape(hkv, p_lanes * chunk_pages, page_size, d).to(c.dtype)
            )
            # decode KV: one row per (lane, token) at (page, row)
            k_full[:, dec_pages + i * num_pages, dec_rows] = k[:, dec_src].to(c.dtype)
            v_full[:, dec_pages + i * num_pages, dec_rows] = v[:, dec_src].to(c.dtype)
            # ONE ragged attention launch for every lane, prefill and decode
            attn = ragged_paged_attention(
                q, k_full, v_full, starts, counts, q_lens, kv_lens, table,
                block_q=block_q, max_q_blocks=max_q_blocks,
            )  # (Hq / tp, T, D)
            # row-parallel output projection: this shard's partial sum
            parts.append(attn.to(dt).transpose(0, 1).reshape(x.shape[0], -1)
                         @ lp["wo"].to(dt).reshape(-1, c.d_model))
        out = _tp_sum(parts)
        if c.use_bias:
            out = out + lps[0]["bo"].to(dt)
        x = _mlp_shards(x + out, lps, c)
    x = _norm(x, shards[0]["lnf_scale"], shards[0].get("lnf_bias"), c.norm)
    # vocab projection ONLY for sample rows: each prefill lane's last real
    # token and each decode lane's Kd token rows
    last = torch.clamp(totals - offsets - 1, 0, chunk - 1)
    pre_rows = torch.arange(p_lanes, device=dev) * chunk + last
    logits = _head_logits(shards, x[torch.cat([pre_rows, dec_src])], c)  # (P+B*Kd, V)
    dec_logits = logits[p_lanes:].reshape(b_lanes, dec_width, -1)
    if squeeze_dec:
        dec_logits = dec_logits[:, 0]
    return logits[:p_lanes], dec_logits, cache


def copy_page(cache: Any, src, dst, *, n_layers: int, mesh: Any = None) -> Any:
    """Copy one logical page (every layer's stripe) src -> dst in the flat
    pool, in place: the device half of copy-on-write. Layer i's stripe
    lives at page + i*num_pages (see init_paged_cache). src / dst are ints
    or 0-d integer tensors. Under a tp mesh, in every shard's pool."""
    for pool in [cache] if _tp(mesh) == 1 else cache:
        k_full, v_full = pool["k"], pool["v"]
        num_pages = k_full.shape[1] // n_layers
        stripes = torch.arange(n_layers, device=k_full.device) * num_pages
        src_idx, dst_idx = stripes + src, stripes + dst
        k_full[:, dst_idx] = k_full[:, src_idx]
        v_full[:, dst_idx] = v_full[:, src_idx]
    return cache


def paged_decode_step(
    params: Params,
    cache: Any,
    block_tables: torch.Tensor,  # (B, maxP) int32
    tokens: torch.Tensor,        # (B,) int
    positions: torch.Tensor,     # (B,) int — write slot; length = position + 1
    config: TransformerConfig,
    *,
    page_size: int,
    rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh: Any = None,
) -> Tuple[torch.Tensor, Any]:
    """One continuous-batching decode step over the paged pool; returns
    (logits (B, V), the pool updated in place). Under a tp `mesh`,
    `params` and `cache` are the shards' (module docstring)."""
    shards, pools = _shards(params, cache, mesh)
    c = config
    dt = c.dtype
    dev = tokens.device
    b = tokens.shape[0]
    positions = positions.long()
    # Overshoot steps of a final decode block run past the block table and
    # past max_seq; XLA clamps such gather indices, and so do these lookups.
    table_pos = torch.clamp(positions, max=c.max_seq - 1)
    x = _embed_shards(shards, tokens, c)[:, None, :]  # (B, 1, E)
    if c.pos_emb == "learned":
        x = x + shards[0]["wpe"][table_pos].to(dt)[:, None, :]
        rope_tables = None
    elif rope_tables is None:
        rope_tables = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=dev)
    lengths = (positions + 1).to(torch.int32)
    tables_l = block_tables.long()
    page_col = torch.clamp(positions // page_size, max=tables_l.shape[1] - 1)
    page_ids = tables_l[torch.arange(b, device=dev), page_col]  # (B,)
    rows = positions % page_size  # (B,)

    num_pages = pools[0]["k"].shape[1] // c.n_layers
    for i in range(c.n_layers):
        lps = [layer_params(p, i) for p in shards]
        h = _norm(x, lps[0]["ln1_scale"], lps[0].get("ln1_bias"), c.norm)[:, 0]  # (B, E)
        e = h.shape[-1]
        table = (tables_l + i * num_pages).to(torch.int32)
        parts = []
        for lp, pool in zip(lps, pools):
            k_full, v_full = pool["k"], pool["v"]
            q = (h @ lp["wq"].to(dt).reshape(e, -1)).view(b, lp["wq"].shape[-2], -1)
            k = (h @ lp["wk"].to(dt).reshape(e, -1)).view(b, lp["wk"].shape[-2], -1)
            v = (h @ lp["wv"].to(dt).reshape(e, -1)).view(b, lp["wv"].shape[-2], -1)
            if c.use_bias:
                q = q + lp["bq"].to(dt)[None]
                k = k + lp["bk"].to(dt)[None]
                v = v + lp["bv"].to(dt)[None]
            if rope_tables is not None:
                cos, sin = rope_tables
                pos2d = table_pos[:, None]
                q = apply_rope(q[:, :, None], cos, sin, pos2d)[:, :, 0]
                k = apply_rope(k[:, :, None], cos, sin, pos2d)[:, :, 0]
            # this token's K/V into each lane's current page/row, in place
            k_full[:, page_ids + i * num_pages, rows] = k.transpose(0, 1).to(c.dtype)
            v_full[:, page_ids + i * num_pages, rows] = v.transpose(0, 1).to(c.dtype)
            attn = paged_attention(q, k_full, v_full, table, lengths,
                                   page_size=page_size)  # (B, Hq / tp, D)
            # row-parallel output projection: this shard's partial sum
            parts.append(attn.to(dt).reshape(b, 1, -1) @ lp["wo"].to(dt).reshape(-1, c.d_model))
        out = _tp_sum(parts)
        if c.use_bias:
            out = out + lps[0]["bo"].to(dt)
        x = _mlp_shards(x + out, lps, c)
    x = _norm(x, shards[0]["lnf_scale"], shards[0].get("lnf_bias"), c.norm)
    return _head_logits(shards, x[:, 0], c), cache
