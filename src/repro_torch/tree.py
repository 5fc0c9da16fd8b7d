"""Nested containers of tensors ("trees"), walked as JAX walks pytrees.

The reference's training code maps over parameter and optimizer-state
pytrees with ``jax.tree``; the port's keeps the same trees (dicts,
lists, ``Quantized`` named tuples, tensors) and walks them here.  Dict
keys are visited in sorted order and paths are spelled as
``jax.tree_util.keystr`` spells them (``['group0'][0]['attn']``,
``.q``), so a checkpoint's manifest lists the leaves in the reference's
order under the reference's paths.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Tuple

__all__ = ["leaves", "flatten_with_paths", "map_tree", "from_paths"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in the reference's order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_paths(tree[k], f"{prefix}['{k}']")]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in flatten_with_paths(getattr(tree, f),
                                               f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, t in enumerate(tree)
                for item in flatten_with_paths(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def map_tree(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """``fn`` over the leaves of ``tree`` (and the matching subtrees of
    ``rest``, which follow ``tree``'s structure down to its leaves, as
    ``treedef.flatten_up_to`` does); the result has ``tree``'s
    structure, its dicts' keys sorted, and ``fn`` is called in the order
    of :func:`leaves`.  ``is_leaf(x)`` stops the walk at ``x``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest),
                                     is_leaf=is_leaf)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def from_paths(items, namedtuples: dict = None):
    """Rebuild a tree from ``[(path, leaf)]``: ``['k']`` a dict key,
    ``[i]`` a list index, ``.f`` a field of the named tuple type that
    ``namedtuples`` maps its field names (a frozenset) to."""
    namedtuples = namedtuples or {}
    root: dict = {}
    for path, leaf in items:
        node, keys = root, []
        for m in _TOKEN.finditer(path):
            key, idx, attr = m.groups()
            keys.append(("k", key) if key is not None else
                        ("i", int(idx)) if idx is not None else ("a", attr))
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        kinds = {kind for kind, _ in node}
        if kinds == {"i"}:
            return [build(node[("i", i)]) for i in range(len(node))]
        if kinds == {"a"}:
            cls = namedtuples[frozenset(k for _, k in node)]
            return cls(**{k: build(v) for (_, k), v in node.items()})
        return {k: build(v) for (_, k), v in node.items()}

    return build(root)
