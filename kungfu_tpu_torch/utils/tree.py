"""Pytrees of tensors: nested dicts, lists and tuples with tensor leaves.

The subset of ``jax.tree_util`` the training step needs.  Dict keys are
visited in sorted order, as ``jax.tree_util`` visits them, so a
flattened tree (a fused gradient buffer) has the reference's layout.
``None`` is an empty subtree, as in jax, and a ``NamedTuple`` (an
optimizer state) is a node whose children are its fields, in order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

#: a tree's structure: ("dict", keys, children) | ("list"/"tuple", n,
#: children) | ("namedtuple", type, children) | ("none",) | ("leaf",)
TreeDef = Tuple


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", tuple(keys), tuple(d for _, d in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(t) for t in tree]
        kind = ("namedtuple", type(tree)) if hasattr(tree, "_fields") else \
            (type(tree).__name__, len(tree))
        return ([l for ls, _ in parts for l in ls],
                kind + (tuple(d for _, d in parts),))
    if tree is None:
        return [], ("none",)
    return [tree], ("leaf",)


def tree_flatten_with_path(tree, _prefix: tuple = ()
                           ) -> Tuple[List[Tuple[tuple, Any]], TreeDef]:
    """``([(path, leaf)], treedef)`` in :func:`tree_flatten`'s order, as
    ``jax.tree_util.tree_flatten_with_path`` gives it; a path is the
    tuple of keys from the root: the dict key, the sequence index, or
    the named tuple's field name."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten_with_path(tree[k], _prefix + (k,))
                 for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", tuple(keys), tuple(d for _, d in parts)))
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        parts = [tree_flatten_with_path(t, _prefix + (k,))
                 for k, t in zip(names, tree)]
        kind = ("namedtuple", type(tree)) if hasattr(tree, "_fields") else \
            (type(tree).__name__, len(tree))
        return ([l for ls, _ in parts for l in ls],
                kind + (tuple(d for _, d in parts),))
    if tree is None:
        return [], ("none",)
    return [(_prefix, tree)], ("leaf",)


def _count(treedef: TreeDef) -> int:
    kind = treedef[0]
    if kind == "leaf":
        return 1
    if kind == "none":
        return 0
    return sum(_count(d) for d in treedef[2])


def num_leaves(treedef: TreeDef) -> int:
    """The leaf count of a structure (``treedef.num_leaves`` in jax)."""
    return _count(treedef)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    leaves = list(leaves)
    if len(leaves) != _count(treedef):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{_count(treedef)}")
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        children = [build(c) for c in d[2]]
        if kind == "dict":
            return dict(zip(d[1], children))
        if kind == "namedtuple":
            return d[1](*children)
        return children if kind == "list" else tuple(children)

    return build(treedef)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree structures differ")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
