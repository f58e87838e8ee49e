"""K2: weighted gather-aggregate, ``out[b] = Σ_k w[b,k] · feat[idx[b,k]]``.

The aggregation of GraphSAGE layers 1..L-1 when
``aggregate_impl="pallas"``.  Counterpart of the TPU kernel
``repro/kernels/gather_agg.py::gather_agg_pallas``; the CUDA kernel is
``repro_torch/csrc/gather_agg.cu`` on the row tiles of
``csrc/tile_accum.cuh``, whose headers say what bounds it on an H100 and
how the tile layout answers that.

* :func:`gather_agg_plain` — the plain PyTorch version: the sequential
  k loop, each step ``out + w·row`` rounded as two operations.  The CPU path
  and the tests use it, and the card's parity check holds the kernel to it.
* :func:`gather_agg_cuda` — the wrapper: checks its operands, picks the
  access path (:func:`access_path`), allocates the output, launches the
  kernel on the current stream and counts the launch in :data:`launches`
  and its path in :data:`path_calls`.  It never falls back to the plain version.

:func:`access_path` serves K3 as well (``repro_torch/sampling/kernels.py``)
and, for each of its two tables, K1 (``cache_lookup.lookup_access_path``);
the tile plan is the kernels' own (``csrc/tile_accum.cuh``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._ext import LaunchCounter, load_kernels

launches = LaunchCounter()
# launches by access path: "vector" (4 columns per access) or "scalar"
path_calls = {"vector": LaunchCounter(), "scalar": LaunchCounter()}

TABLE_DTYPES = (torch.float32, torch.bfloat16)


def access_path(table: torch.Tensor) -> str:
    """``"vector"`` when the kernels can read ``table``'s rows 4 columns at
    a time (D % 4 == 0 and the first row 16-byte aligned for f32, 8-byte
    for bf16: 4 elements), else ``"scalar"`` (one column per thread)."""
    aligned = table.data_ptr() % (4 * table.element_size()) == 0
    return "vector" if table.shape[-1] % 4 == 0 and aligned else "scalar"


def gather_agg_plain(feat: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """out[b] = Σ_k w[b,k] · feat[idx[b,k]], summed over k in ascending
    order in f32.  [B, D] float32 on ``feat``'s device."""
    bsz, num_k = idx.shape
    idx = idx.long()
    wf = w.float()
    out = torch.zeros((bsz, feat.shape[1]), dtype=torch.float32,
                      device=feat.device)
    for k in range(num_k):
        out = out + wf[:, k:k + 1] * feat.index_select(0, idx[:, k]).float()
    return out


def check_rows(name: str, t: torch.Tensor, device: torch.device,
               dtypes: tuple, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d tensor of one of
    ``dtypes`` on ``device`` (the kernels take raw pointers)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gather_agg_cuda(feat: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Launch K2.  feat [N, D] f32/bf16, idx [B, K] int32, w [B, K] f32, all
    contiguous on one CUDA device -> [B, D] f32."""
    if not feat.is_cuda:
        raise ValueError(f"gather_agg_cuda needs CUDA tensors, got "
                         f"{feat.device}")
    dev = feat.device
    check_rows("feat", feat, dev, TABLE_DTYPES, 2)
    check_rows("idx", idx, dev, (torch.int32,), 2)
    check_rows("w", w, dev, (torch.float32,), 2)
    if w.shape != idx.shape:
        raise ValueError(f"w {tuple(w.shape)} != idx {tuple(idx.shape)}")
    out = torch.empty((idx.shape[0], feat.shape[1]), dtype=torch.float32,
                      device=dev)
    if out.numel():                  # an empty grid is not a valid launch
        path = access_path(feat)
        load_kernels().gather_agg(feat, idx, w, out, path == "vector",
                                  0)   # 0: the kernel's own tile plan
        launches.add()
        path_calls[path].add()
    return out
