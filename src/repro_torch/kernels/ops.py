"""Public entry points of the ported kernels (single device, no mesh).

Dispatch is by device alone, the same for every op: a CPU tensor runs the
plain PyTorch version, a CUDA tensor launches the hand-written CUDA kernel
— or the wrapper raises.  There is no fallback from a CUDA tensor to the
plain version, and no option that selects one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cache_lookup import (cache_lookup_agg_cuda,
                                              cache_lookup_agg_plain)
from repro_torch.kernels.gather_agg import gather_agg_cuda, gather_agg_plain


def gather_agg(feat: torch.Tensor, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Fused gather + weighted aggregation (K2).  [B, D] f32."""
    if not feat.is_cuda:
        return gather_agg_plain(feat, idx, w)
    return gather_agg_cuda(feat, idx, w)


def cache_lookup_agg(cache_table: torch.Tensor, streamed: torch.Tensor,
                     slots: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Fused GNS input layer (K1): cache/streamed select + gather-agg.
    [B, D] f32.  Forward only: its backward waits for the training port."""
    if not cache_table.is_cuda:
        return cache_lookup_agg_plain(cache_table, streamed, slots, idx, w)
    return cache_lookup_agg_cuda(cache_table, streamed, slots, idx, w)
