"""Nested dicts of tensors (the models' params and grads) as JAX flattens
them: leaves in sorted-key order, which is `jax.tree_util`'s order for a
dict and `ravel_pytree`'s for a flat vector."""

from __future__ import annotations

from typing import Any, Callable, Dict

Tree = Any  # nested dict of tensors, as the models' params


def leaves(tree: Tree) -> list:
    """Leaves in sorted-key order (the order JAX flattens a dict)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """fn on every leaf, visited in the order of `leaves`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def nest(flat: Dict[str, Any]) -> Tree:
    """Path-keyed leaves ("blocks/attn/wo") -> nested dicts."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out
