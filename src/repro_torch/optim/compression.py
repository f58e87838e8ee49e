"""Gradient compression with error feedback for the data-parallel
all-reduce (port of ``repro.optim.compression``).

The standard int8 uniform quantization with *error feedback* (EF-SGD,
Karimireddy et al. '19): the quantization residual is carried to the next
step, which restores the full convergence rate despite about 4x less
all-reduce traffic.  On a mesh of ranks::

    q, scale = compress_int8(grad)
    q_sum    = all_reduce(q as int32, group)       # the data group
    grad'    = q_sum * scale / n_ranks

``compress_int8`` rounds half to even (``torch.round``), as the
reference's ``jnp.round`` does, so both give the same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.scan_util import tree_leaves, tree_map, tree_unflatten


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: x ≈ q * scale."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: Any  # a tree matching the gradients'

    @staticmethod
    def init(params):
        return ErrorFeedbackState(residual=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))


def ef_compress_update(grads, ef: ErrorFeedbackState, group=None):
    """Error-feedback compressed (pseudo-)all-reduce.

    Adds the carried residual, quantizes to int8, sums the int8 values as
    int32 over the process group ``group`` (the reference's ``psum`` over
    ``axis_name``; None: no reduction) and scales by this rank's scale
    over the group's size, and stores the new residual = (input -
    quantized).  Returns (decompressed grads, new EF state)."""
    def one(g, r):
        x = g.float() + r
        q, scale = compress_int8(x)
        if group is not None:
            qsum = q.to(torch.int32)
            dist.all_reduce(qsum, group=group)
            out = qsum.float() * scale / dist.get_world_size(group)
        else:
            out = decompress_int8(q, scale)
        return out, x - decompress_int8(q, scale)

    outs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                       tree_leaves(ef.residual))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            ErrorFeedbackState(residual=tree_unflatten(
                grads, [o[1] for o in outs])))
