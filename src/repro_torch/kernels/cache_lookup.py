"""K1: fused cache lookup + layer-0 gather-aggregate.

    h0[r]    = slots[r] >= 0 ? cache_table[slots[r]] : streamed[r]
    out[b,:] = Σ_k  w[b, k] · h0[idx[b, k], :]

The GNS input layer (``input_impl="fused"``): every input row is resolved
against the device cache and aggregated into the first GraphSAGE layer in
one pass, without materialising h0.  Counterpart of the TPU kernel
``repro/kernels/cache_lookup.py::cache_lookup_agg_pallas``; the CUDA kernel
is ``repro_torch/csrc/cache_lookup.cu``, whose header says what bounds it on
an H100 (HBM bytes) and how its design answers that: it reads
``slots[idx[b,k]]`` itself and loads only the live row.

* :func:`cache_lookup_agg_plain` — the plain PyTorch version, the
  sequential-k loop of ``repro/kernels/ref.py::cache_lookup_agg_ref``.  The
  CPU path and the tests use it, and the card's parity check holds the
  kernel to it.
* :func:`cache_lookup_agg_cuda` — the wrapper: checks its operands,
  allocates the output, launches the kernel on the current stream and
  counts the launch in :data:`launches`.  It never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._ext import LaunchCounter, load_kernels
from repro_torch.kernels.gather_agg import TABLE_DTYPES, check_rows

launches = LaunchCounter()


def cache_lookup_agg_plain(cache_table: torch.Tensor, streamed: torch.Tensor,
                           slots: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """out[b] = Σ_k w[b,k] · (s >= 0 ? cache[s] : streamed[idx[b,k]]) with
    s = slots[idx[b,k]], summed over k in ascending order in f32."""
    bsz, num_k = idx.shape
    d = cache_table.shape[1]
    idx = idx.long()
    s = slots.long()[idx]                                          # [B, K]
    hit_rows = cache_table.index_select(0, s.clamp(min=0).reshape(-1))
    miss_rows = streamed.index_select(0, idx.reshape(-1))
    rows = torch.where((s >= 0).reshape(-1, 1), hit_rows.float(),
                       miss_rows.float()).reshape(bsz, num_k, d)
    wf = w.float()
    out = torch.zeros((bsz, d), dtype=torch.float32, device=cache_table.device)
    for k in range(num_k):       # matches the kernel's accumulation order
        out = out + wf[:, k:k + 1] * rows[:, k]
    return out


def cache_lookup_agg_cuda(cache_table: torch.Tensor, streamed: torch.Tensor,
                          slots: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Launch K1.  cache [C, D] f32/bf16, streamed [S0, D] f32, slots [S0]
    int32, idx/w [B, K] int32/f32, all contiguous on one CUDA device ->
    [B, D] f32."""
    if not cache_table.is_cuda:
        raise ValueError(f"cache_lookup_agg_cuda needs CUDA tensors, got "
                         f"{cache_table.device}")
    dev = cache_table.device
    check_rows("cache_table", cache_table, dev, TABLE_DTYPES, 2)
    check_rows("streamed", streamed, dev, (torch.float32,), 2)
    check_rows("slots", slots, dev, (torch.int32,), 1)
    check_rows("idx", idx, dev, (torch.int32,), 2)
    check_rows("w", w, dev, (torch.float32,), 2)
    if streamed.shape[1] != cache_table.shape[1]:
        raise ValueError(f"streamed width {streamed.shape[1]} != cache "
                         f"width {cache_table.shape[1]}")
    if slots.shape[0] != streamed.shape[0]:
        raise ValueError(f"slots {slots.shape[0]} != streamed rows "
                         f"{streamed.shape[0]}")
    if w.shape != idx.shape:
        raise ValueError(f"w {tuple(w.shape)} != idx {tuple(idx.shape)}")
    out = torch.empty((idx.shape[0], cache_table.shape[1]),
                      dtype=torch.float32, device=dev)
    if out.numel():                  # an empty grid is not a valid launch
        load_kernels().cache_lookup_agg(cache_table, streamed, slots, idx, w,
                                        out)
        launches.add()
    return out
