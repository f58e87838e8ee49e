"""AdamW as ``repro.optim.adam`` defines it (not ``torch.optim.AdamW``).

The reference folds weight decay into the update (``delta + wd·p``, then
``p - lr·delta``), takes the bias corrections as ``1 - b ** step`` in f32,
and stores the moments in ``moment_dtype`` (the update math runs in f32;
bfloat16 moments are rounded on store).  The optimizer here keeps that
interface: ``state = init(params)``, ``params, state = update(grads, state,
params)``, over the params' ``{"layers": [{"w", "b"}]}`` dict of tensors.

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


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-3                 # paper §4.1: ADAM, lr 0.003
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None
    moment_dtype: Any = torch.float32  # torch.bfloat16 halves moment memory


def tree_leaves(tree: dict) -> list:
    """The tensors of a ``{"layers": [{name: tensor}]}`` tree, in layer
    order and, within a layer, in sorted name order (as jax flattens a
    dict, so trees whose dicts were built in another order still match)."""
    return [layer[name] for layer in tree["layers"] for name in sorted(layer)]


def tree_map(fn, tree: dict) -> dict:
    return {"layers": [{name: fn(t) for name, t in layer.items()}
                       for layer in tree["layers"]]}


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    Returns ``(clipped grads, norm before clipping)``."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


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
    def update(self, grads: dict, state: dict, params: dict) -> tuple:
        """One step, in place (module docstring).  Returns ``(params,
        state)``."""
        cfg = self.cfg
        if cfg.clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, cfg.clip_norm)
        step = state["step"] + 1
        lr, b1, b2 = cfg.lr, cfg.b1, cfg.b2
        if self.lr_schedule is not None:      # f32, as the reference's jnp
            lr = float(np.float32(self.lr_schedule(step)) * np.float32(lr))
        step_f = np.float32(step)        # the corrections in f32
        bc1 = float(np.float32(1.0) - np.float32(b1) ** step_f)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** step_f)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g32 = g.float()
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
