"""Leaf paths of nested containers, named as the JAX package names them.

A path joins, with ".", a dict's key, a NamedTuple's field name or a
sequence's index; ``None`` holds no leaf.  The checkpoint manifest and
``models.transformer.params_from_jax`` name leaves this way, so a flat
dict keyed by ``named_parameters()`` names yields the JAX pytree's paths.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the container's own order."""
    def join(key):
        return f"{prefix}.{key}" if prefix else str(key)

    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out += flatten_with_paths(sub, join(key))
    return out


def map_leaves(fn: Callable[[str, Any], Any], tree: Any, prefix: str = ""):
    """The same containers with each leaf replaced by ``fn(path, leaf)``."""
    def join(key):
        return f"{prefix}.{key}" if prefix else str(key)

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, v, join(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
