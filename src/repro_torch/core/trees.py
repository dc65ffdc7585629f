"""Nested containers of tensors (dicts, lists, tuples) walked leaf by leaf:
the port's stand-in for ``jax.tree.map`` / ``jax.tree.leaves``."""
from __future__ import annotations

from typing import Callable, Optional


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` applied to each leaf of ``tree`` and the leaves at the same
    place in ``rest`` (trees of the same structure).  ``is_leaf(node)``
    marks containers to hand to ``fn`` whole."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def leading_dim(tree) -> int:
    """First-axis size of a tensor or of a (dict-of-tensors) batch tree,
    e.g. an LM task's ``{"tokens": (K, B, S)}``."""
    return tree_leaves(tree)[0].shape[0]
