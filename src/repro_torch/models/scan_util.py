"""Layer loops over stacked parameters (port of ``repro.models.scan_util``).

The reference runs its layers with ``jax.lax.scan`` over parameter leaves
stacked on a leading ``[L, ...]`` axis.  PyTorch runs eagerly, so
:func:`scan` is a Python loop over that axis; the stacked layout stays, so
the reference's parameters load as they are.

The loop splits each stacked leaf once per call with ``torch.unbind(0)``.
The layers are views of the stack, as ``leaf[i]`` would be, so serving's
in-place cache writes reach the stacked cache.  Under autograd the
backward of ``leaf[i]`` would materialise a zero tensor of the whole
``[L, ...]`` stack for every layer (L stacks written and summed per leaf),
while the backward of one ``unbind`` is one ``stack``; the values and the
gradients are the same bit for bit.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.sharding import current_mesh, use_mesh


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts / lists / tuples (``rest``
    must share ``tree``'s structure), visiting them in
    :func:`tree_leaves`' order; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in ``jax.tree_util``'s flatten order: dict keys sorted,
    list and tuple items in order; None is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure holding ``leaves`` (in :func:`tree_leaves`'
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _unbind_layers(tree: Any) -> list:
    """Every layer of a stacked tree, from one ``torch.unbind(0)`` per
    leaf (views; the backward of each leaf's split is one ``stack``)."""
    leaves = tree_leaves(tree)
    split = [torch.unbind(x, 0) for x in leaves]
    return [tree_unflatten(tree, [s[i] for s in split])
            for i in range(leaves[0].shape[0])]


def remat_call(f: Callable, *args):
    """``f(*args)`` under ``torch.utils.checkpoint`` (non-reentrant: only
    the inputs are kept, ``f`` runs again in backward).  Backward can run
    on another thread than the forward (CUDA's autograd has a thread per
    device), so the recompute re-enters the mesh scope of the forward
    (``launch.sharding.use_mesh``), which the layers' mesh branches
    read."""
    mesh = current_mesh()
    return checkpoint(f, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), use_mesh(mesh)))


def scan(f: Callable, init: Any, xs: Any, remat: bool = False):
    """``lax.scan`` as a loop: ``carry, y = f(carry, layer_i)`` for each
    layer in order (module docstring: one ``unbind`` per leaf); returns
    the last carry and the ``y``s stacked on axis 0 (None when ``f``
    returns None).  ``remat``: while autograd
    records, each step runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of the scan body: only the step's inputs
    are kept, the rest is recomputed in backward)."""
    if remat and torch.is_grad_enabled():
        f = functools.partial(remat_call, f)
    carry, ys = init, []
    for bp in _unbind_layers(xs):
        carry, y = f(carry, bp)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a, dim=0), *ys)
