"""One walker over state trees: dicts, lists, tuples and dataclasses.

The checkpoint writer names each leaf by its path and rebuilds a target's
structure on restore; the cost layer copies a step's arguments onto meta
tensors. Leaves are whatever is not a node (tensors, Python scalars)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple


def _is_node(tree: Any) -> bool:
    return isinstance(tree, (dict, list, tuple)) or (
        dataclasses.is_dataclass(tree) and not isinstance(tree, type)
    )


def _items(tree: Any) -> Iterator[Tuple[str, Any]]:
    """(key, child) pairs of a dict, list/tuple or dataclass node."""
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))


def flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) over the tree, paths "/"-joined keys."""
    if _is_node(tree):
        for key, child in _items(tree):
            yield from flatten(child, f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def rebuild(target: Any, fn: Callable[[str, Any], Any], prefix: str = "") -> Any:
    """The target's tree with each leaf replaced by fn(path, leaf); a
    dataclass is rebuilt from its init fields."""
    if isinstance(target, dict):
        return {k: rebuild(v, fn, f"{prefix}{k}/") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(rebuild(v, fn, f"{prefix}{i}/") for i, v in enumerate(target))
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: rebuild(getattr(target, f.name), fn, f"{prefix}{f.name}/")
            for f in dataclasses.fields(target) if f.init
        })
    return fn(prefix.rstrip("/"), target)
