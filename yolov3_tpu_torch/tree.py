"""Nested dicts of tensors (params, BN state, optimizer moments, metrics):
the three helpers the port needs in place of a pytree library."""

from __future__ import annotations


def tree_leaves(tree):
    """Leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """The structure of ``like`` filled with ``leaves`` (sorted-key order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
