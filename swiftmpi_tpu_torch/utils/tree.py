"""Pytrees of tensors, as the JAX package's ``jax.tree`` sees them.

The transformer family keeps JAX's layout for its parameters and its
optimizer state: nested dicts, tuples and named tuples (``MoEParams``,
the optimizer's states) whose leaves are tensors.  These helpers walk
them in JAX's flatten order (a dict's keys sorted, a tuple's fields in
order), so leaf ``i`` of the port is leaf ``i`` of the JAX package, and
:func:`treedef_repr` writes the structure as JAX's ``repr(PyTreeDef)``
does, the string a trainer checkpoint stores beside its leaves.
"""

from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, tuple, list))


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX's flatten order (``None`` has none)."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [tree]
    out = []
    for c in _children(tree):
        out += leaves(c)
    return out


def _rebuild(like, children: list):
    if isinstance(like, dict):
        return dict(zip(sorted(like), children))
    if _is_namedtuple(like):
        return type(like)(*children)
    return type(like)(children)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of one structure); the result has ``tree``'s
    structure."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    kids = zip(_children(tree), *(_children(r) for r in rest))
    return _rebuild(tree, [tree_map(fn, *k) for k in kids])


def unflatten(like, flat) -> Any:
    """A tree of ``like``'s structure whose leaves are ``flat``, taken in
    JAX's flatten order."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def treedef_repr(tree) -> str:
    """``repr(jax.tree.structure(tree))``: ``*`` for a leaf, dicts by
    sorted key, a named tuple as ``CustomNode(namedtuple[Name], [...])``."""
    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(walk(c) for c in t) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(walk(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(walk(c) for c in t) + "]"
        return "*"
    return f"PyTreeDef({walk(tree)})"
