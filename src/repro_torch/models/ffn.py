"""Dense FFN: gated (SwiGLU/GeGLU) and plain MLP variants (port of
``repro.models.ffn``; the reference's sharding constraints have no
counterpart without a mesh)."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype) -> dict:
    p = {"w1": dense_init(gen, d_model, d_ff, dtype),
         "w2": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["w3"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def ffn_forward(p: dict, cfg_act: str, x: torch.Tensor,
                gated: bool = True) -> torch.Tensor:
    """x: [..., d_model]."""
    act = activation(cfg_act)
    h = x @ p["w1"]
    if gated:
        h = act(h) * (x @ p["w3"])
    else:
        h = act(h)
    return h @ p["w2"]
