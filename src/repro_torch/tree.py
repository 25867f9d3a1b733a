"""The ``jax.tree`` operations the port uses, over its trees of
tensors (port-only: the reference calls ``jax.tree``).

A tree is a dict, list, tuple or NamedTuple of trees, ``None`` (no leaf)
or a leaf.  ``leaves`` walks it in ``jax.tree.leaves`` order: dict keys
sorted, NamedTuple fields and list items in order.  That order numbers the
leaves of a checkpoint (``train/checkpoint.py``), so a checkpoint written
by either package holds the same leaf at the same index.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, NamedTuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """The subtrees in leaf order, or None for a leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _rebuild(like, children: List[Any]):
    """A container of ``like``'s type from ``children`` in leaf order."""
    if isinstance(like, dict):
        by_key = dict(zip(sorted(like), children))
        return {k: by_key[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*children)
    return type(like)(children)


def leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order."""
    out: List[Any] = []

    def walk(t):
        if t is None:
            return
        kids = _children(t)
        if kids is None:
            out.append(t)
        else:
            for k in kids:
                walk(k)

    walk(tree)
    return out


def unflatten(like, flat) -> Any:
    """``like``'s structure with its leaves, in :func:`leaves` order, taken
    from ``flat``."""
    it: Iterator = iter(flat)

    def build(t):
        if t is None:
            return None
        kids = _children(t)
        if kids is None:
            return next(it)
        return _rebuild(t, [build(k) for k in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 (jax.tree.map)
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (each of ``tree``'s structure)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [map(fn, k, *(o[i] for o in others))
                           for i, k in enumerate(kids)])


class DictKey(NamedTuple):
    """A dict key on a leaf's path (``jax.tree_util.DictKey``); a list,
    tuple or NamedTuple child is named by its position, an ``int``."""
    key: Any


def map_with_path(fn: Callable, tree) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree`` (``jax.tree_util.
    tree_map_with_path``): ``path`` is the tuple of :class:`DictKey` and
    positions from the root to the leaf."""

    def walk(path, t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(path + (DictKey(k),), v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            kids = [walk(path + (i,), v) for i, v in enumerate(t)]
            return type(t)(*kids) if _is_namedtuple(t) else type(t)(kids)
        return fn(path, t)

    return walk((), tree)
