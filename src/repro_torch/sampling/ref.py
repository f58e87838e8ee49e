"""Plain PyTorch version of the device-sampling gather (port of
``repro.sampling.ref``): the oracle that kernel K3 is held to."""
from __future__ import annotations

import torch


def slot_gather_agg_plain(cache_table: torch.Tensor, lane_rows: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """out[b] = Σ_k w[b,k] · cache_table[lane_rows[b,k]]; dead lanes
    (``lane_rows < 0``) contribute w = 0 times row 0.

    The sequential k loop in f32, each step ``out + w·row`` rounded as two
    operations: the order of the reference's K-innermost grid and of K3.
    [B, D] float32 on the table's device.
    """
    lr = lane_rows.long()
    rows = lr.clamp(min=0)
    wf = torch.where(lr >= 0, w.float(), torch.zeros((), device=w.device))
    out = torch.zeros((lr.shape[0], cache_table.shape[1]),
                      dtype=torch.float32, device=cache_table.device)
    for k in range(lr.shape[1]):
        out = out + wf[:, k:k + 1] * cache_table.index_select(
            0, rows[:, k]).float()
    return out
