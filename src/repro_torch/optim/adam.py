"""AdamW as ``repro.optim.adam`` defines it (not ``torch.optim.AdamW``).

The reference folds weight decay into the update (``delta + wd·p``, then
``p - lr·delta``), takes the bias corrections as ``1 - b ** step`` in f32,
and stores the moments in ``moment_dtype`` (the update math runs in f32;
bfloat16 moments are rounded on store).  The optimizer here keeps that
interface: ``state = init(params)``, ``params, state = update(grads, state,
params)``, over any nested dict / list of tensors (GraphSAGE's ``{"layers":
[{"w", "b"}]}``, an LM's stacked tree), leaf by leaf in ``jax.tree_util``'s
flatten order (dict keys sorted).  Clipping scales each f32 gradient leaf
as the update reaches it, so no clipped copy of the whole tree is made.

A leaf above :data:`SLICE_ELEMENTS` elements is updated, and its squares
summed for the clipping norm, slice by slice (:func:`leaf_slices`), so the
f32 temporaries of the update are those of one slice, not of the leaf (the
reference's update runs fused inside its jitted step and keeps none).
Elementwise arithmetic does not depend on where a slice starts, so the
sliced update is bit for bit the whole leaf's, given the same clipping
scale; only the norm of a leaf above one slice sums in another order.

One difference from the functional reference: :meth:`AdamW.update` writes
the new parameters and moments into the existing tensors, under
``torch.no_grad()``, and returns them.  That saves a copy of every
parameter and moment per step; nothing else holds those tensors across a
step.  ``state["step"]`` is a Python int (the reference's int32 scalar),
so no step reads a counter back from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.scan_util import tree_leaves, tree_map

# the most elements of a leaf that one slice of the update (and of the
# norm) covers: its f32 temporaries are 268 MB each
SLICE_ELEMENTS = 2 ** 26


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-3                 # paper §4.1: ADAM, lr 0.003
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None
    moment_dtype: Any = torch.float32  # torch.bfloat16 halves moment memory


def leaf_slices(*leaves: torch.Tensor) -> list:
    """Views of same-shape ``leaves`` that together cover them, each of at
    most :data:`SLICE_ELEMENTS` elements: the leaves themselves where they
    fit one slice; else consecutive pieces of their flattened storage
    where all are contiguous, or pieces along the first dim.  Returns one
    tuple of views a slice."""
    n, limit = leaves[0].numel(), SLICE_ELEMENTS
    if n <= limit:
        return [leaves]
    if all(t.is_contiguous() for t in leaves):
        flat = [t.reshape(-1) for t in leaves]
        return [tuple(t[i:i + limit] for t in flat)
                for i in range(0, n, limit)]
    rows = max(limit // (n // leaves[0].shape[0]), 1)
    return [tuple(t[i:i + rows] for t in leaves)
            for i in range(0, leaves[0].shape[0], rows)]


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    """The f32 sum of ``g``'s squares, over its slices in order."""
    sums = [torch.sum(torch.square(s.float())) for s, in leaf_slices(g)]
    return sum(sums[1:], sums[0])


def global_norm(grads, plans=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``grads`` together, in f32.

    ``plans``: the leaves' ``ShardPlan``s on a mesh (``launch/
    sharding.py``), where ``grads`` holds this rank's blocks: the squares
    of the leaves that shard over some axes are summed over those axes'
    groups, and a replicated leaf counts once, so every rank gets the
    norm of the full tree."""
    if plans is None:
        return torch.sqrt(sum(_sum_squares(g) for g in tree_leaves(grads)))
    from repro_torch.launch.collectives import all_reduce
    sums: dict = {}                  # the axes a leaf shards over -> sum
    mesh = None
    for g, plan in zip(tree_leaves(grads), tree_leaves(plans)):
        sq = _sum_squares(g)
        sums[plan.axes] = sums[plan.axes] + sq if plan.axes in sums else sq
        mesh = plan.mesh
    total = None
    for axes, sq in sums.items():     # one order on every rank
        for a in sorted(axes):
            sq = all_reduce(sq, mesh.group(a))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float) -> tuple:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    Returns ``(clipped grads, norm before clipping)``.  The clipped leaves
    are f32, as the reference's (a bf16 leaf times its f32 scale)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


class AdamW:
    """AdamW: ``state = init(params)``, ``params, state = update(...)``."""

    def __init__(self, cfg: AdamConfig = AdamConfig(),
                 lr_schedule: Optional[Callable[[int], Any]] = None):
        """``lr_schedule``: step -> multiplier of ``cfg.lr``
        (:mod:`repro_torch.optim.schedules`), taken at the step being made
        (1 for the first update), as the reference does."""
        self.cfg = cfg
        self.lr_schedule = lr_schedule

    def init(self, params: dict) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.cfg.moment_dtype,
                               device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict,
               plans=None) -> tuple:
        """One step, in place (module docstring).  Returns ``(params,
        state)``.  ``plans``: on a mesh, the leaves' ``ShardPlan``s (the
        clipping norm is the full tree's, :func:`global_norm`); the
        moments are the shape of the local leaves, so they follow the
        plans."""
        cfg = self.cfg
        scale = None                 # clipping, applied leaf by leaf below
        if cfg.clip_norm is not None:
            scale = _clip_scale(global_norm(grads, plans), cfg.clip_norm)
        step = state["step"] + 1
        lr, b1, b2 = cfg.lr, cfg.b1, cfg.b2
        if self.lr_schedule is not None:      # f32, as the reference's jnp
            lr = float(np.float32(self.lr_schedule(step)) * np.float32(lr))
        step_f = np.float32(step)        # the corrections in f32
        bc1 = float(np.float32(1.0) - np.float32(b1) ** step_f)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** step_f)
        for leaf in zip(tree_leaves(params), tree_leaves(grads),
                        tree_leaves(state["m"]), tree_leaves(state["v"])):
            for p, g, m, v in leaf_slices(*leaf):
                g32 = g.float() if scale is None else g.float() * scale
                m32 = m.float() * b1 + (1 - b1) * g32
                v32 = v.float() * b2 + (1 - b2) * torch.square(g32)
                delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
                if cfg.weight_decay:
                    delta = delta + cfg.weight_decay * p.float()
                p.copy_(p.float() - lr * delta)
                m.copy_(m32)
                v.copy_(v32)
        state["step"] = step
        return params, state


def adam_state_from_numpy(tree: dict, device=None,
                          moment_dtype: Any = torch.float32) -> dict:
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy arrays,
    e.g. ``jax.device_get`` of its state) -> the port's, with the moments
    on ``device`` (``None``: the GPU) in ``moment_dtype``, so a run can
    continue a reference run."""
    dev = resolve_device(device)

    def tensor(a):        # np.array copies, so the result owns its memory
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            dev, dtype=moment_dtype)

    return {"m": tree_map(tensor, tree["m"]), "v": tree_map(tensor, tree["v"]),
            "step": int(np.asarray(tree["step"]))}
