"""K1: fused cache lookup + layer-0 gather-aggregate.

    h0[r]    = slots[r] >= 0 ? cache_table[slots[r]] : streamed[r]
    out[b,:] = Σ_k  w[b, k] · h0[idx[b, k], :]

The GNS input layer (``input_impl="fused"``): every input row is resolved
against the device cache and aggregated into the first GraphSAGE layer in
one pass, without materialising h0.  Counterpart of the TPU kernel
``repro/kernels/cache_lookup.py::cache_lookup_agg_pallas``; the CUDA kernel
is ``repro_torch/csrc/cache_lookup.cu`` on the row tiles of
``csrc/tile_accum.cuh``, whose headers say what bounds it on an H100 (the
padded output at the training shape, the launch and latency at the serve
shapes) and how its design answers that: the tile's lanes follow
``idx[b,k]`` to ``slots`` together, and each lane loads only its live row.

* :func:`cache_lookup_agg_plain` — the plain PyTorch version, the
  sequential-k loop of ``repro/kernels/ref.py::cache_lookup_agg_ref``.  The
  CPU path and the tests use it, and the card's parity check holds the
  kernel to it bit for bit.
* :func:`cache_lookup_agg_cuda` — the wrapper: checks its operands, picks
  the access path (:func:`lookup_access_path`), allocates the output,
  launches the kernel on the current stream and counts the launch in
  :data:`launches` and its path in :data:`path_calls`.  It never falls
  back.

One shard of a row-sharded cache (``repro.kernels.cache_lookup``'s
shard-local views): shard ``s`` of ``n`` holds the contiguous global slots
``[s·rps, (s+1)·rps)``.  :func:`shard_slot_map` maps global slots to its
local rows, :func:`shard_lane_weights` zeroes the lanes it does not
contribute, and :func:`cache_lookup_agg_shard_partial` runs K1 on its
local table (the plain version on the CPU): the partials of all shards sum
to the single-device result.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._ext import LaunchCounter, load_kernels
from repro_torch.kernels.gather_agg import (TABLE_DTYPES, access_path,
                                            check_rows)

launches = LaunchCounter()
# launches by access path: "vector" (4 columns per access) or "scalar"
path_calls = {"vector": LaunchCounter(), "scalar": LaunchCounter()}


def lookup_access_path(cache_table: torch.Tensor,
                       streamed: torch.Tensor) -> str:
    """``"vector"`` when K1 can read both of its tables 4 columns at a
    time (:func:`~repro_torch.kernels.gather_agg.access_path` of each:
    D % 4 == 0, the cache 16-byte aligned in f32 or 8-byte in bf16, the
    streamed rows 16-byte aligned), else ``"scalar"``."""
    vec = access_path(cache_table) == access_path(streamed) == "vector"
    return "vector" if vec else "scalar"


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
        path = lookup_access_path(cache_table, streamed)
        load_kernels().cache_lookup_agg(cache_table, streamed, slots, idx, w,
                                        out, path == "vector",
                                        0)   # 0: the kernel's own tile plan
        # one count per eager call; a captured step would count once per
        # capture, so the capture must count its replays itself
        launches.add()  # gnscheck: ignore[trace-mutation]
        path_calls[path].add()
    return out


# ---------------------------------------------------------------------------
# shard-local views (global slot -> (shard, local row), contiguous blocks)
# ---------------------------------------------------------------------------

def shard_slot_map(slots: torch.Tensor, shard: int,
                   rows_per_shard: int) -> torch.Tensor:
    """Global slot map -> this shard's local rows; everything else -> -1.

    Shard ``s`` owns the contiguous global slots ``[s·rps, (s+1)·rps)`` —
    the rows it holds of a table row-sharded over the cache axis.  int32,
    ``slots``' shape."""
    slots = slots.to(torch.int32)
    lo = shard * rows_per_shard
    owned = (slots >= lo) & (slots < lo + rows_per_shard)
    return torch.where(owned, slots - lo, -1).to(torch.int32)


def shard_lane_weights(w: torch.Tensor, lane_slots: torch.Tensor, shard: int,
                       rows_per_shard: int) -> torch.Tensor:
    """Zero every lane this shard does not contribute (f32).

    A lane is contributed by exactly one shard: cache hits by the shard
    owning the slot, misses (slot < 0, served from the replicated streamed
    rows) by shard 0.  Summing the per-shard partials therefore recovers
    the single-device result — with only zero terms added, so
    integer-valued inputs reproduce it bitwise."""
    lo = shard * rows_per_shard
    owned = (lane_slots >= lo) & (lane_slots < lo + rows_per_shard)
    contribute = owned | ((lane_slots < 0) & (shard == 0))
    return torch.where(contribute, w.float(), 0.0)


def cache_lookup_agg_shard_partial(local_table: torch.Tensor,
                                   streamed: torch.Tensor,
                                   slots: torch.Tensor, idx: torch.Tensor,
                                   w: torch.Tensor, shard: int,
                                   rows_per_shard: int,
                                   claim_all: bool = False) -> torch.Tensor:
    """One shard's partial of the fused lookup: K1 on the LOCAL table
    (``local_table`` [rps, D], global ``slots``), its plain version on the
    CPU.  [B, D] f32.

    ``claim_all=True`` is the local fast path's partial: every lane, hit
    and miss, is claimed by this shard (weights unmasked), so under the
    host's contract that all hit slots live here this one partial equals
    the single-device result bitwise.  Hit slots NOT on this shard map to
    -1 and would wrongly read their (zeroed) streamed rows — the caller
    must hold the contract."""
    local_slots = shard_slot_map(slots, shard, rows_per_shard)
    if claim_all:
        w_eff = w.float()
    else:
        lane_slots = slots.long()[idx.long()]
        w_eff = shard_lane_weights(w, lane_slots, shard, rows_per_shard)
    if not local_table.is_cuda:
        return cache_lookup_agg_plain(local_table, streamed, local_slots,
                                      idx, w_eff)
    return cache_lookup_agg_cuda(local_table, streamed, local_slots,
                                 idx.to(torch.int32).contiguous(),
                                 w_eff.contiguous())
