"""Nested-dict trees of tensors, walked in the JAX package's leaf order
(dict keys sorted), with key paths for the checkpoint format."""
from __future__ import annotations

from typing import Any, Iterator, Tuple


def map_tree(fn, tree, *rest):
    """``fn(leaf, *others)`` at every leaf of ``tree``; each of ``rest``
    follows ``tree``'s dicts down to its leaves, where it may hold a
    subtree (an int8 moment's ``{"q", "scale"}`` at a parameter's place)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs, dict keys in sorted order as ``jax.tree``
    flattens them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]
