"""Trees of tensors: nested dicts, lists and tuples, walked in ``jax.tree``
order (dict keys sorted, lists and tuples in order).  Anything else,
``None`` included, is a leaf, and so is any node for which ``is_leaf``
(a keyword of each function) returns true: a tree of partition specs, which
are tuples, passes ``sharding.is_spec``."""
from __future__ import annotations

from typing import Any, List


def _is_node(tree, is_leaf=None) -> bool:
    return isinstance(tree, (dict, list, tuple)) and not (is_leaf and is_leaf(tree))


def _rebuild(node, items):
    """A list or tuple (a named tuple too) of ``node``'s type holding ``items``."""
    return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree``; each tree of ``rest`` is flattened
    only as deep as ``tree`` (``flatten_up_to``), so a state entry such as
    adafactor's ``(row, col)`` pair reaches ``fn`` whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_node(tree, is_leaf):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], is_leaf)]
    if _is_node(tree, is_leaf):
        return [leaf for v in tree for leaf in tree_leaves(v, is_leaf)]
    return [tree]


def tree_unflatten(like, leaves, is_leaf=None) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_node(node, is_leaf):
            return _rebuild(node, [build(v) for v in node])
        return next(it)

    return build(like)
