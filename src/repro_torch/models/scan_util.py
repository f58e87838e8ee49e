"""Layer loops over stacked parameters (port of ``repro.models.scan_util``).

The reference runs its layers with ``jax.lax.scan`` over parameter leaves
stacked on a leading ``[L, ...]`` axis.  PyTorch runs eagerly, so
:func:`scan` is a Python loop over that axis; the stacked layout stays, so
the reference's parameters load as they are.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts / lists / tuples (``rest``
    must share ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree: views ``leaf[i]``, no copies."""
    return tree_map(lambda x: x[i], tree)


def num_layers(tree: Any) -> int:
    leaf = tree
    while isinstance(leaf, (dict, list, tuple)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return leaf.shape[0]


def scan(f: Callable, init: Any, xs: Any):
    """``lax.scan`` as a loop: ``carry, y = f(carry, layer(xs, i))`` for i
    in order; returns the last carry and the ``y``s stacked on axis 0
    (None when ``f`` returns None)."""
    carry, ys = init, []
    for i in range(num_layers(xs)):
        carry, y = f(carry, layer(xs, i))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a, dim=0), *ys)
