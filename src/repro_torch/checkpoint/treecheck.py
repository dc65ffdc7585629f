"""Leaves of the port's trees in the reference's order, and compatibility
checks that name the leaf at fault (mirrors ``repro/checkpoint/
treecheck.py``).

The port's trees are dataclasses (fields in order) of flat dicts whose
``/``-joined names stand for the reference's nested dicts, plus lists and
tuples.  `named_leaves` walks a dict's keys sorted by their ``/`` parts,
which is the order ``jax.tree_util`` walks the nested dicts in, so a list
of leaves saved by either package lines up with the other's state.  An
absent slot (``None``) holds no leaf, as the reference's ``()`` does.
"""
from __future__ import annotations

import dataclasses

_MAX_NAMED = 8   # cap the listing; a different model mismatches everything


def _walk(tree, path: tuple):
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, dict):
        for k in sorted(tree, key=lambda k: tuple(str(k).split("/"))):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (f"[{i}]",))
    else:
        yield path, tree


def named_leaves(tree) -> list:
    """``[("clients.params.c1/w", leaf), ...]`` in the reference's order."""
    return [(".".join(p) or "<root>", v) for p, v in _walk(tree, ())]


def nodes_at_leaves(tree, like) -> list:
    """The nodes of ``tree`` at the paths of ``like``'s leaves, in
    `named_leaves` order: e.g. the spec of each leaf from a spec tree
    shaped as the state (whose own leaves are tuples)."""
    out = []
    for path, _ in _walk(like, ()):
        node = tree
        for p in path:
            if dataclasses.is_dataclass(node):
                node = getattr(node, p)
            elif isinstance(node, dict):
                node = node[p]
            else:
                node = node[int(p[1:-1])]
        out.append(node)
    return out


def with_leaves(like, leaves):
    """``like`` with its leaves replaced, in `named_leaves` order."""
    by_path = dict(zip((p for p, _ in _walk(like, ())), leaves))

    def build(t, path):
        if t is None:
            return None
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name), path + (f.name,))
                for f in dataclasses.fields(t)})
        if isinstance(t, dict):
            return {k: build(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, path + (f"[{i}]",))
                           for i, v in enumerate(t))
        return by_path[path]

    return build(like, ())


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def tree_mismatches(like, tree) -> list[str]:
    """Differences between ``tree`` and the reference ``like``: the leaf
    names first, then each leaf's shape and dtype.  Empty: compatible."""
    a, b = named_leaves(like), named_leaves(tree)
    if [n for n, _ in a] != [n for n, _ in b]:
        missing = sorted({n for n, _ in a} - {n for n, _ in b})
        extra = sorted({n for n, _ in b} - {n for n, _ in a})
        return [f"tree structure differs: expected {len(a)} leaves, got "
                f"{len(b)} (missing {missing[:_MAX_NAMED]}, unexpected "
                f"{extra[:_MAX_NAMED]})"]
    msgs = []
    for (name, x), (_, y) in zip(a, b):
        if tuple(x.shape) != tuple(y.shape) or _dtype(x) != _dtype(y):
            msgs.append(f"{name}: expected {tuple(x.shape)} {_dtype(x)}, "
                        f"got {tuple(y.shape)} {_dtype(y)}")
    if len(msgs) > _MAX_NAMED:
        msgs = msgs[:_MAX_NAMED] + [f"... and {len(msgs) - _MAX_NAMED} more"]
    return msgs


def assert_tree_compatible(like, tree, what: str = "tree") -> None:
    """Raise ``ValueError`` naming every mismatched leaf when ``tree`` does
    not match ``like`` in leaf names, shapes and dtypes."""
    msgs = tree_mismatches(like, tree)
    if msgs:
        raise ValueError(f"{what} does not match the expected tree (same "
                         f"model and config?):\n  " + "\n  ".join(msgs))
