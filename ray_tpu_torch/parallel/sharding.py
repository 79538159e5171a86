"""Sharding-rule engine: logical axis names → mesh PartitionSpecs.

Port of `ray_tpu/parallel/sharding.py`. Every parameter carries logical
axis names (e.g. ("embed", "mlp")) and a rule table maps logical names to
mesh axes. Two rule systems compose:
- logical rules: [("embed", "fsdp"), ("mlp", "tp"), ...] applied to
  logical-axis tuples (the common path for models built in this repo)
- path-regex rules: [(r".*attn/wq", P("fsdp", "tp")), ...] applied to
  parameter tree paths (escape hatch for foreign trees)

The rules, specs and divisibility checks are JAX's. Placing a tree by
them (`tree_shardings`, `shard_tree`) gives each rank its block of every
leaf on the meshes the port builds (dp, fsdp, tp; `mesh.py`): a spec
that names an axis of size 1 keeps that dimension whole, one that names
axes of size > 1 splits it over them. `NamedSharding.assemble` puts the
ranks' blocks back together. A dimension that does not divide by its
axes raises ValueError (`validate_divisibility`), as JAX's `device_put`
refuses it: GPT-2's vocabulary of 50257 over tp = 2 is one
(`override_rules(default_rules(), vocab=None)` keeps it whole). The
collectives that compute on these blocks are `parallel/spmd.py`'s.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple, Union

from ..util.tree import rebuild
from .mesh import Mesh, NamedSharding, PartitionSpec

MeshAxis = Union[None, str, Tuple[str, ...]]
LogicalRules = Sequence[Tuple[str, MeshAxis]]

P = PartitionSpec


# ---------------------------------------------------------------- rule tables
# Standard tables for the canonical mesh axes (mesh.AXIS_ORDER). Batch-like
# logical axes map to the data axes; hidden dims shard over fsdp (ZeRO-3
# style) and/or tp (Megatron style); experts over ep; sequence over sp.

def default_rules() -> List[Tuple[str, MeshAxis]]:
    return [
        ("batch", ("dp", "fsdp")),
        ("seq", "sp"),
        ("kv_seq", None),          # ring attention shards kv blocks manually
        ("embed", "fsdp"),         # param hidden dim: ZeRO-3 shard
        ("heads", "tp"),           # attention heads: Megatron split
        ("kv_heads", "tp"),
        ("head_dim", None),
        ("mlp", "tp"),             # ffn hidden: Megatron split
        ("vocab", "tp"),
        ("expert", "ep"),
        ("layers", None),          # stacked layer axis stays unsharded
        ("stage", "pp"),
    ]


def override_rules(base: LogicalRules, **overrides: MeshAxis) -> List[Tuple[str, MeshAxis]]:
    out = [(k, overrides.pop(k)) if k in overrides else (k, v) for k, v in base]
    out.extend(overrides.items())
    return out


# ------------------------------------------------------------- logical system


def logical_to_spec(logical_axes: Sequence[Optional[str]], rules: LogicalRules) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec.

    No mesh axis is used twice in one spec: a later logical axis that would
    reuse a mesh axis falls back to None (replicated on that dim), in
    flax's resolution order."""
    table = dict(rules)
    used: set = set()
    out: List[MeshAxis] = []
    for name in logical_axes:
        if name is None:
            out.append(None)
            continue
        axes = table.get(name)
        if axes is None:
            out.append(None)
            continue
        axes_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        free = tuple(a for a in axes_tuple if a not in used)
        if not free:
            out.append(None)
            continue
        used.update(free)
        out.append(free if len(free) > 1 else free[0])
    return PartitionSpec(*out)


def _is_logical(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _map_logical(fn, tree: Any) -> Any:
    """Apply fn to every logical-axis tuple of a tree of dicts / lists."""
    if _is_logical(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_logical(fn, v) for v in tree)
    raise TypeError(f"not a logical-axis tree node: {type(tree).__name__}")


def tree_specs(logical_tree: Any, rules: LogicalRules) -> Any:
    """Map a tree of logical-axis tuples to a tree of PartitionSpecs."""
    return _map_logical(lambda axes: logical_to_spec(axes, rules), logical_tree)


def tree_shardings(logical_tree: Any, rules: LogicalRules, mesh: Mesh) -> Any:
    return _map_logical(
        lambda axes: NamedSharding(mesh, logical_to_spec(axes, rules)), logical_tree
    )


def shard_tree(tree: Any, logical_tree: Any, rules: LogicalRules, mesh: Mesh) -> Any:
    """This rank's blocks of a parameter tree, by its logical axes, on the
    mesh's device (each a copy of its own, not a view of the global
    leaf). A dimension that does not divide by its axes raises."""
    if _is_logical(logical_tree):
        spec = logical_to_spec(logical_tree, rules)
        validate_divisibility(tree.shape, spec, mesh)
        return NamedSharding(mesh, spec).shard(tree).to(mesh.device).clone()
    if isinstance(logical_tree, dict):
        return {k: shard_tree(tree[k], v, rules, mesh) for k, v in logical_tree.items()}
    return type(logical_tree)(shard_tree(t, v, rules, mesh) for t, v in zip(tree, logical_tree))


# ---------------------------------------------------------------- path system


def path_specs(tree: Any, path_rules: Sequence[Tuple[str, PartitionSpec]]) -> Any:
    """PartitionSpec per leaf by regex match on '/'-joined tree path:
    search semantics (a rule matches anywhere in the path; anchor with
    ^...$ for an exact match); the first rule that matches wins."""
    compiled = [(re.compile(pat), spec) for pat, spec in path_rules]

    def spec_for(path: str, _leaf) -> PartitionSpec:
        for pat, spec in compiled:
            if pat.search(path):
                return spec
        return PartitionSpec()

    return rebuild(tree, spec_for)


# ------------------------------------------------------------------ utilities


def validate_divisibility(shape: Sequence[int], spec: PartitionSpec, mesh: Mesh, name: str = "") -> None:
    """Raise early (with a readable message) if a dim doesn't divide by its
    mesh axes."""
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            continue
        axes_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        total = 1
        for a in axes_tuple:
            total *= mesh.shape[a]
        if dim % total != 0:
            raise ValueError(
                f"{name}: dim of size {dim} not divisible by mesh axes "
                f"{axes_tuple} (product {total})"
            )
