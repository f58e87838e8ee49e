"""LR schedules as step -> multiplier functions (port of
``repro.optim.schedules``), composed with ``AdamConfig.lr`` by
:class:`~repro_torch.optim.adam.AdamW`.

Each takes the step as a Python int and returns a float32 scalar
(``np.float32``), computed in float32 as the reference's ``jnp`` does, so
no step reads a value back from the card.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant():
    return lambda step: _F(1.0)


def warmup_cosine(warmup_steps: int, total_steps: int, min_frac: float = 0.1):
    def sched(step):
        s = _F(step)
        warm = np.minimum(s / _F(max(warmup_steps, 1)), _F(1.0))
        prog = np.clip((s - _F(warmup_steps))
                       / _F(max(total_steps - warmup_steps, 1)),
                       _F(0.0), _F(1.0))
        cos = _F(min_frac) + _F(1 - min_frac) * _F(0.5) * (
            _F(1) + np.cos(_F(np.pi) * prog))
        return _F(warm * cos)
    return sched


def inverse_sqrt(warmup_steps: int):
    def sched(step):
        s = np.maximum(_F(step), _F(1.0))
        w = _F(max(warmup_steps, 1))
        return _F(np.minimum(s / w, np.sqrt(w / s)))
    return sched
