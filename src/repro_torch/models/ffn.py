"""Dense FFN: gated (SwiGLU/GeGLU) and plain MLP variants (port of
``repro.models.ffn``).

On a mesh whose ``model`` axis shards the hidden width (the rule table:
``w1``/``w3`` column-parallel, ``w2`` row-parallel), each rank holds a
block of the hidden units: the input enters through ``copy_to`` and the
partial outputs are summed over the model group (Megatron's MLP)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch.collectives import copy_to, model_group, reduce_from
from repro_torch.launch.sharding import model_sharded
from repro_torch.models.common import activation, dense_init


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype) -> dict:
    p = {"w1": dense_init(gen, d_model, d_ff, dtype),
         "w2": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["w3"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def ffn_forward(p: dict, cfg_act: str, x: torch.Tensor,
                gated: bool = True, d_ff: Optional[int] = None
                ) -> torch.Tensor:
    """x: [..., d_model].  ``d_ff``: the full hidden width, which says
    whether the mesh in scope shards it (None: never, the families that
    train without tensor parallelism)."""
    group = model_group()[0] if d_ff and model_sharded(d_ff) else None
    x = copy_to(x, group)
    act = activation(cfg_act)
    h = x @ p["w1"]
    if gated:
        h = act(h) * (x @ p["w3"])
    else:
        h = act(h)
    return reduce_from(h @ p["w2"], group)
