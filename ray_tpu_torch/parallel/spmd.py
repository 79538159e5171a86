"""The port's explicit stand-in for GSPMD: ZeRO-3 gathers over the data
axes and Megatron's tensor-parallel collectives over tp.

JAX trains a mesh past dp by giving the state the rule table's specs
(`sharding.py`) and letting XLA's GSPMD partitioner insert the
collectives. PyTorch has no such partitioner, so `ModelSharding` writes
them out for the transformer of `models/transformer.py`, from the same
specs, as autograd pairs:

- A dimension split over tp whose logical axis names heads, the MLP's
  hidden units or the vocabulary stays local when every weight of its
  group is split alike: the attention's q / k / v / o heads with their
  biases, the MLP's up / gate / down, the embedding's vocabulary, the
  head's vocabulary. That is Megatron's scheme: `enter` before the
  column-parallel products (identity forward, all-reduce of the
  gradient), `leave` after the row-parallel product (all-reduce forward,
  identity backward), a vocab-parallel embedding (the rows outside this
  rank's range masked, then `leave`) and a vocab-parallel loss
  (`VocabShard`, read by `ops/losses.py`).
- The MoE layer's expert dimension split over ep (the rule `("expert",
  "ep")`) stays local the same way, with the pair over ep: each ep rank
  dispatches its copy of the tokens to its E / ep experts (`enter` on
  the tokens and on the gate weights), and the combine's partial sums
  are summed over ep (`leave`), so the replicated weights' gradients come
  out equal on every ep rank (`models/moe.py`). GSPMD partitions JAX's
  e-sharded einsums on its own; the port keeps the batch whole over ep,
  as the default rules do.
- Every other split dimension is gathered just before its weights are
  used, a layer at a time, one collective per layer and axis, in the
  compute dtype: over a data axis (dp, fsdp) the gradient of the
  gathered weight is reduce-scattered back to the blocks in f32, which
  sums the ranks' rows (ZeRO-3); over tp the backward keeps this rank's
  block of a gradient that every tp rank computes whole. While a layer's
  weights are gathered, the model runs each layer under
  `torch.utils.checkpoint` (`gathers_layers`): the forward keeps only the
  layer's input, and the backward runs the layer again, its gathers
  included, so one layer is whole at a time (ZeRO-3).
- After the backward, each gradient is all-reduced over the data axes
  its gathers did not sum already (`sync_grads`); the clip's norm sums
  each leaf's squares over the axes its spec splits, so a replicated
  leaf is counted once (`global_norm`).

Each collective runs in a `Wire.region` of its axis' wire, labelled
`<axis>_gather`, `<axis>_scatter` (the gradients' reduce-scatter),
`<axis>_allreduce` (tp's pairs), `<axis>_sync` (the gradients'
all-reduce after the backward) and `metrics`: `stats()` of each wire
gives their bytes and seconds. On meta tensors (the cost count of
`util/profiling.step_cost`) the collectives make shapes only.

Every rank runs the same program on its blocks, so the collectives meet
in the same order on every rank, the backward's included (the autograd
graph is the same on every rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .collectives import Wire
from .mesh import AXIS_ORDER, DATA_AXES, Mesh, NamedSharding, PartitionSpec, spec_axes
from .sharding import LogicalRules, default_rules, tree_specs

MODEL_AXIS = "tp"
EXPERT_AXIS = "ep"

# Megatron's groups: the logical axes a split keeps local, by group, and
# the mesh axis that splits them (tp, but ep for the MoE layer's experts)
_GROUP_AXES = {"attn": ("heads", "kv_heads"), "mlp": ("mlp",), "expert": ("expert",)}
_GROUP_MESH_AXIS = {"expert": EXPERT_AXIS}


# ------------------------------------------------------------ autograd pairs


class _Gather(torch.autograd.Function):
    """All-gather of several blocks over one axis, each along its own
    dimension, in one collective, cast to `dtype` first (the compute
    dtype the forward casts these weights to: a bf16 gather moves half
    the bytes). Backward: the gradients' blocks, in the blocks' dtype,
    reduce-scattered (summed over the axis) when the axis carries data,
    else this rank's block of each."""

    @staticmethod
    def forward(ctx, wire: Wire, axis: str, dims: Tuple[int, ...], dtype: torch.dtype, *blocks):
        ctx.wire, ctx.axis, ctx.dims = wire, axis, dims
        ctx.shapes, ctx.dtype = [b.shape for b in blocks], blocks[0].dtype
        n = wire.size
        with wire.region(f"{axis}_gather", blocks[0].device):
            flat = torch.cat([b.reshape(-1).to(dtype) for b in blocks])
            rows = wire.gather(flat).view(n, -1)
        out, offset = [], 0
        for b, d in zip(blocks, dims):
            part = rows[:, offset:offset + b.numel()].reshape(n, *b.shape)
            offset += b.numel()
            out.append(part.movedim(0, d).reshape(*b.shape[:d], n * b.shape[d], *b.shape[d + 1:]))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        wire, n = ctx.wire, ctx.wire.size
        rows = torch.cat([
            g.to(ctx.dtype).reshape(*s[:d], n, s[d], *s[d + 1:]).movedim(d, 0).reshape(n, -1)
            for g, s, d in zip(grads, ctx.shapes, ctx.dims)], dim=1)
        if ctx.axis in DATA_AXES:
            with wire.region(f"{ctx.axis}_scatter", rows.device):
                own = wire.reduce_scatter(rows.reshape(-1))
        else:
            own = rows[wire.rank]
        sizes = [s.numel() for s in ctx.shapes]
        return (None, None, None, None, *(part.view(s) for part, s in
                                          zip(torch.split(own, sizes), ctx.shapes)))


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient all-reduced."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, wire: Wire, axis: str):
        ctx.wire, ctx.axis = wire, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with ctx.wire.region(f"{ctx.axis}_allreduce", g.device):
            g = ctx.wire.all_reduce(g.clone(memory_format=torch.contiguous_format))
        return g, None, None


class _Reduce(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, wire: Wire, axis: str):
        with wire.region(f"{axis}_allreduce", x.device):
            return wire.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """This rank's slice of the vocabulary in a vocab-parallel loss: the
    logits' last dimension holds vocabulary rows [start, start + local
    size); `max` and `sum` reduce over the slices' ranks (`sum` with
    the identity as its gradient, every rank's loss being the same)."""

    start: int
    wire: Wire
    axis: str = MODEL_AXIS

    def max(self, x: torch.Tensor) -> torch.Tensor:
        with self.wire.region(f"{self.axis}_allreduce", x.device):
            return self.wire.all_reduce(x.detach().clone(memory_format=torch.contiguous_format),
                                        "max")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.wire, self.axis)


# ------------------------------------------------------------------ the plan


def split_axes(spec: PartitionSpec, dim: int, shape: Dict[str, int]) -> Tuple[str, ...]:
    """The axes of size > 1 (in a mesh of axis sizes `shape`) that split
    dimension `dim` of a leaf laid out by `spec`."""
    if dim >= len(spec):
        return ()
    return tuple(a for a in spec_axes(spec[dim]) if shape[a] > 1)


def megatron_split(specs: Dict[str, PartitionSpec], logical: Any, shape: Dict[str, int]
                   ) -> Tuple[Dict[str, bool], set]:
    """Which of Megatron's groups stay local on a mesh of axis sizes
    `shape`: ({group: split}, the (path, dimension) entries of the split
    groups). A group ("attn", "mlp", "embed": the embedding's vocabulary,
    "head": the LM head's; "expert": the MoE layer's experts, over ep) is
    split when its axis (tp, or ep for "expert") is above 1 and alone
    splits every weight dimension of it that names its logical axes; the
    training step (`ModelSharding`) and the serving layout
    (`serve/llm/paged_engine.serving_shardings`) both read it."""
    names = dict(dict_items(logical))
    groups = {g: [(p, d) for p, axes in names.items() if p.startswith("blocks/")
                  for d, a in enumerate(axes) if a in logical_names]
              for g, logical_names in _GROUP_AXES.items()}
    groups["embed"] = [("wte", 0)]
    groups["head"] = [("lm_head", 1)] if "lm_head" in names else [("wte", 0)]
    split = {}
    for g, entries in groups.items():
        axis = group_axis(g)
        split[g] = shape[axis] > 1 and bool(entries) and all(
            split_axes(specs[p], d, shape) == (axis,) for p, d in entries)
    return split, {e for g, entries in groups.items() if split[g] for e in entries}


def group_axis(group: str) -> str:
    """The mesh axis that splits a Megatron group: ep for the experts, tp
    for the others."""
    return _GROUP_MESH_AXIS.get(group, MODEL_AXIS)


def vocab_rows(wte: torch.Tensor, tokens: torch.Tensor, start: int,
               dtype: torch.dtype) -> torch.Tensor:
    """A vocab-parallel embedding's partial rows: the rows of the tokens
    inside this block's range [start, start + rows) in `dtype`, zeros for
    the others. Summed over the blocks they give the embedding exactly
    (one block's row is nonzero)."""
    size = wte.shape[0]
    local = tokens.long() - start
    inside = (local >= 0) & (local < size)
    return wte[local.clamp(0, size - 1)].masked_fill(~inside[..., None], 0.0).to(dtype)


class ModelSharding:
    """The collectives of a model whose parameters are this rank's blocks
    by `rules` over `mesh` (the logical-axis tree is
    `models.transformer.logical_axes(config)`).

    `split[group]` says which Megatron groups stay local ("attn", "mlp",
    "embed" for the embedding's vocabulary, "head" for the LM head's);
    `steps[path]` lists the (dimension, axis) gathers of each leaf, the
    innermost axis of a dimension first; `gathers_layers` says whether a
    layer's weights are gathered (the model then checkpoints each layer,
    so the backward gathers it again)."""

    def __init__(self, mesh: Mesh, logical: Any, rules: Optional[LogicalRules] = None):
        if mesh.local:
            raise ValueError(
                f"ModelSharding runs one rank's blocks per process; this mesh holds "
                f"{len(mesh.devices)} local devices (a serving program over its tp shards)"
            )
        self.mesh = mesh
        rules = rules or default_rules()
        self.specs: Dict[str, PartitionSpec] = dict(dict_items(tree_specs(logical, rules)))
        self.wires = {axis: Wire.for_axis(mesh, axis) for axis in AXIS_ORDER
                      if mesh.shape[axis] > 1}
        self.split, local = megatron_split(self.specs, logical, mesh.shape)
        self.steps: Dict[str, List[Tuple[int, str]]] = {}
        for path, spec in self.specs.items():
            steps = [(d, a) for d in range(len(spec)) if (path, d) not in local
                     for a in reversed(self.axes(path, d))]
            if path.startswith("blocks/") and any(d == 0 for d, _ in steps):
                raise NotImplementedError(
                    f"{path}: its stacked layer axis is split ({spec}); layers over "
                    f"ranks are pipeline stages: train such a mesh with "
                    f"parallel.pipeline.make_pp_train_step")
            self.steps[path] = steps
        self.gathers_layers = any(self.steps[p] for p in self.steps if p.startswith("blocks/"))

    # ---------------------------------------------------------- layout

    def axes(self, path: str, dim: int) -> Tuple[str, ...]:
        """The axes of size > 1 that split dimension `dim` of a leaf."""
        return split_axes(self.specs[path], dim, self.mesh.shape)

    def leaf_axes(self, path: str) -> Tuple[str, ...]:
        """Every axis of size > 1 that splits the leaf, in mesh order."""
        used = {a for d in range(len(self.specs[path])) for a in self.axes(path, d)}
        return tuple(a for a in AXIS_ORDER if a in used)

    # --------------------------------------------------------- gathers

    def _gather(self, tensors: Dict[str, torch.Tensor], steps: Dict[str, List],
                dtype: Optional[torch.dtype]) -> Dict:
        """Each tensor with its steps' dimensions gathered (cast to `dtype`):
        in rounds (the k-th step of every leaf), one collective per round
        and axis."""
        out = dict(tensors)
        pending = {name: list(s) for name, s in steps.items() if s}
        while pending:
            by_axis: Dict[str, List[Tuple[str, int]]] = {}
            for name, todo in pending.items():
                dim, axis = todo.pop(0)
                by_axis.setdefault(axis, []).append((name, dim))
            for axis in AXIS_ORDER:
                if axis in by_axis:
                    names = [name for name, _ in by_axis[axis]]
                    dims = tuple(dim for _, dim in by_axis[axis])
                    full = _Gather.apply(self.wires[axis], axis, dims, dtype,
                                         *(out[n] for n in names))
                    out.update(zip(names, full))
            pending = {name: todo for name, todo in pending.items() if todo}
        return out

    def gather_layer(self, lp: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """One layer's weights (views of the stacked blocks) with their
        split dimensions gathered, those in `dtype`."""
        steps = {name: [(d - 1, a) for d, a in self.steps[f"blocks/{name}"]] for name in lp}
        return self._gather(lp, steps, dtype)

    def gather_leaf(self, name: str, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A top-level leaf with its split dimensions gathered (in `dtype`
        when there are any)."""
        return self._gather({name: w}, {name: self.steps[name]}, dtype)[name]

    # ------------------------------------------------------ tp's pairs

    def enter(self, group: str, x: torch.Tensor) -> torch.Tensor:
        """The input of a split group's column-parallel products."""
        if not self.split[group]:
            return x
        axis = group_axis(group)
        return _Copy.apply(x, self.wires[axis], axis)

    def leave(self, group: str, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group's axis (tp; ep for the experts) of a
        split group's partial outputs."""
        if not self.split[group]:
            return x
        axis = group_axis(group)
        return _Reduce.apply(x, self.wires[axis], axis)

    def expert_range(self, n_experts: int) -> Tuple[int, int]:
        """[first, last) of the experts this rank holds: all of them unless
        the experts are split over ep."""
        if not self.split["expert"]:
            return 0, n_experts
        size = n_experts // self.mesh.shape[EXPERT_AXIS]
        first = self.mesh.axis_index(EXPERT_AXIS) * size
        return first, first + size

    def embed(self, wte: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Embedding rows of `tokens` in `dtype`; under a vocabulary split
        each rank looks up the rows in its range, zeroes the others and
        the ranks' rows are summed (exact: one of them is nonzero)."""
        if not self.split["embed"]:
            return wte[tokens.long()].to(dtype)
        start = self.mesh.axis_index(MODEL_AXIS) * wte.shape[0]
        return self.leave("embed", vocab_rows(wte, tokens, start, dtype))

    def vocab_shard(self, local_size: int) -> Optional[VocabShard]:
        """The loss's slice of the vocabulary, `local_size` columns of
        logits, or None when the head is whole."""
        if not self.split["head"]:
            return None
        start = self.mesh.axis_index(MODEL_AXIS) * local_size
        return VocabShard(start, self.wires[MODEL_AXIS])

    # ------------------------------------------------- after the backward

    def data_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the data axes, the gradient passed through as it
        is (a statistic of the global batch built from each rank's rows:
        its gradient reaches each rank's rows unchanged)."""
        for axis in DATA_AXES:
            if axis in self.wires:
                x = _Reduce.apply(x, self.wires[axis], axis)
        return x

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the data axes (no gradient), in place on a copy."""
        x = x.detach().clone()
        for axis in DATA_AXES:
            if axis in self.wires:
                with self.wires[axis].region("metrics", x.device):
                    self.wires[axis].all_reduce(x)
        return x

    @torch.no_grad()
    def sync_grads(self, paths: Sequence[str], grads: List[torch.Tensor]) -> None:
        """In place: each gradient block all-reduced over the data axes
        that do not split its leaf (those its gathers' reduce-scatter did
        not sum), one f32 collective per axis for every leaf at once."""
        for axis in DATA_AXES:
            if axis not in self.wires:
                continue
            idx = [i for i, p in enumerate(paths) if axis not in self.leaf_axes(p)]
            if not idx:
                continue
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            with self.wires[axis].region(f"{axis}_sync", flat.device):
                self.wires[axis].all_reduce(flat)
            for i, part in zip(idx, torch.split(flat, [grads[i].numel() for i in idx])):
                grads[i] = part.view(grads[i].shape).to(grads[i].dtype)

    @torch.no_grad()
    def sumsq(self, paths: Sequence[str], tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the squares of the global leaves whose blocks these
        are, f64: each leaf's block sum over the axes its spec splits,
        replicated leaves counted once."""
        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        for path, t in zip(paths, tensors):
            key = self.leaf_axes(path)
            part = t.float().square().sum(dtype=torch.float64)
            by_axes[key] = by_axes[key] + part if key in by_axes else part
        keys = sorted(by_axes, key=lambda k: [AXIS_ORDER.index(a) for a in k])
        for axis in AXIS_ORDER:
            mine = [k for k in keys if axis in k]
            if mine:
                v = torch.stack([by_axes[k] for k in mine])
                with self.wires[axis].region("metrics", v.device):
                    self.wires[axis].all_reduce(v)
                by_axes.update(zip(mine, v))
        return torch.stack([by_axes[k] for k in keys]).sum()

    def num_params(self, params: Any) -> int:
        """The elements of the global leaves whose blocks `params` holds."""
        total = 0
        for path, block in dict_items(params):
            count = block.numel()
            for d in range(len(self.specs[path])):
                count *= NamedSharding(self.mesh, self.specs[path]).parts(d)[0]
            total += count
        return total

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Every wire's {label: calls, bytes, seconds}, the labels unique
        across the axes."""
        out: Dict[str, Dict[str, float]] = {}
        for wire in self.wires.values():
            for label, row in wire.stats().items():
                if label in out:
                    out[label] = {k: out[label][k] + row[k] for k in row}
                else:
                    out[label] = row
        return out

    def reset(self) -> None:
        for wire in self.wires.values():
            wire.reset()


def dict_items(tree: Dict[str, Any], prefix: str = ""):
    """(path, leaf) over a tree of dicts, paths "/"-joined keys: the
    leaves of a parameter tree, of its logical axes or of its specs."""
    for key, child in tree.items():
        if isinstance(child, dict):
            yield from dict_items(child, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", child


def model_sharded(mesh: Optional[Mesh], logical: Any, rules: Optional[LogicalRules]) -> bool:
    """Whether a model on this mesh needs `ModelSharding`: an axis past
    dp of size > 1, or a parameter that the rules split over dp."""
    if mesh is None or mesh.size == 1:
        return False
    if any(mesh.shape[a] > 1 for a in AXIS_ORDER if a != "dp"):
        return True
    specs = dict_items(tree_specs(logical, rules or default_rules()))
    return any("dp" in spec_axes(entry) for _, spec in specs for entry in spec)
