"""Nested dicts and tuples of leaves (``repro``'s pytrees) as paths.

``flatten`` walks a tree in ``jax.tree``'s order (dict keys sorted,
tuples in order) and gives each leaf's path; ``nest`` builds the tree
back from ``(path, leaf)`` pairs (integer keys make tuples).  A subclass
of tuple (a sharding spec) is a leaf.
"""

from __future__ import annotations


def flatten(tree, path: tuple = ()) -> list[tuple[tuple, object]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k],
                                                            path + (k,))]
    if type(tree) in (tuple, list):
        return [kv for i, v in enumerate(tree) for kv in flatten(
            v, path + (i,))]
    return [(path, tree)]


def nest(pairs) -> dict:
    root: dict = {}
    for path, leaf in pairs:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return tuple(fix(node[i]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}
    return fix(root)
