"""Device-resident GNS layer 0: draw → fallback merge → gather (port of
``repro.sampling.kernels``).

* :func:`draw_lanes_plain` — the candidate draw and its importance weights,
  op for op as the reference's ``draw_lanes``: per destination row, if the
  row has ``n_c <= k`` cached neighbors it takes all of them (lanes past
  ``n_c`` are dead), otherwise it makes ``k`` uniform draws with
  replacement (``bits % n_c``, counter RNG ``rng.mix32``).  Both regimes
  weight a lane ``w = 1/(max(p^C_u · min(k, n_c)/n_c, 1e-6) · max(deg, 1))``
  in f32, the host sampler's eq. (10)-(12) formula.
* :func:`sample_lanes_plain` — the draw merged with the host's fallback
  lanes: destination rows the cache does not cover (``dst_rows < 0``) take
  ``fb_rows``/``fb_w`` as they are.
* :func:`gns_sample_agg_plain` — the merged lanes through
  :func:`~repro_torch.sampling.ref.slot_gather_agg_plain`.  The CPU path
  and the tests use it; the card's parity check holds K3 to it.
* :func:`gns_sample_agg_cuda` — the wrapper of kernel K3
  (``csrc/gns_sample_agg.cu``, row tiles of ``csrc/tile_accum.cuh``): draw,
  merge and gather in one launch, counted in :data:`launches` and its
  access path in :data:`path_calls`.
* :func:`gns_sample_agg` — the entry the model's layer 0 calls; it
  dispatches by device alone (the plain version on the CPU, K3 on the
  card, never a fallback from one to the other).

**Row range** (``row_lo``, ``row_count``): the plain version and K3 gather
only from a table holding the global rows ``[row_lo, row_lo +
row_count)`` — one shard of a row-sharded cache.  The draw and the
fallback merge run over the whole (replicated) CSR as before; a lane
outside the range gets weight 0, a lane inside reads local row ``row -
row_lo``.  The default, the whole table, is the unsharded op bit for bit,
and the shards' partials sum to it.  The reference draws globally, gathers
per shard with foreign lanes at weight 0 and psums
(``repro.sampling.kernels.gns_sample_agg``'s mesh branch); K3 fuses the
draw with the gather, so each shard draws all lanes and keeps its own.
With ``mesh=`` and ``shard_axis=`` (:mod:`repro_torch.launch.mesh`, one
process per mesh position, ``cache_table`` this rank's shard)
:func:`gns_sample_agg` runs its shard's partial and all-reduces it over
the cache group.

The op is forward only, as the reference's is: the layer-0 aggregate does
not depend on the parameters, and the reference wraps every operand in
``stop_gradient``.  Here the model passes detached tensors, and the op
raises if an operand requires grad.

Keys: the batch carries its key as a host numpy ``uint32 [1, 2]`` array
(``DeviceBatch.sample_key``); the two words reach the kernel as scalars,
so the step never reads the key back from the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._ext import LaunchCounter, load_kernels
from repro_torch.kernels.gather_agg import (TABLE_DTYPES, access_path,
                                           check_rows)
from repro_torch.sampling.adjacency import DeviceCacheAdj
from repro_torch.sampling.ref import slot_gather_agg_plain
from repro_torch.sampling.rng import mix32

launches = LaunchCounter()
# launches by access path, as kernels.gather_agg.path_calls
path_calls = {"vector": LaunchCounter(), "scalar": LaunchCounter()}

MAX_LANES = 32          # a row's lanes in shared memory (tile_accum.cuh)


def key_words(key) -> tuple[int, int]:
    """(key_lo, key_hi) of a one-group key: a host ``uint32 [1, 2]`` array
    or a pair of ints.  A tensor on the card is refused, not read back."""
    k = np.asarray(key, dtype=np.uint32).reshape(-1, 2)
    if k.shape[0] != 1:
        raise ValueError(f"one key per batch expected, got {k.shape[0]} "
                         "(a group-collated batch draws per group: "
                         "models.graphsage splits it)")
    return int(k[0, 0]), int(k[0, 1])


def draw_lanes_plain(adj: DeviceCacheAdj, dst_rows: torch.Tensor, key,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-destination cached-neighbor draw with importance weights.

    ``dst_rows`` int [B]: the device-table row of each destination (-1 =
    not cached or padding: those rows draw nothing).  Returns
    ``(rows, w)`` of shape [B, k]: int32 table rows (-1 = dead lane) and
    f32 weights (0 on dead lanes).
    """
    dev = dst_rows.device
    key_lo, key_hi = key_words(key)
    bsz = dst_rows.shape[0]
    dst = dst_rows.long()
    rowc = dst.clamp(min=0)
    indptr = adj.indptr.long()
    start = indptr[rowc]
    n_c = indptr[rowc + 1] - start                              # [B]

    local = torch.arange(bsz, dtype=torch.int64, device=dev)
    lane = torch.arange(k, dtype=torch.int64, device=dev)
    bits = mix32(key_lo, key_hi, local[:, None], lane[None, :])  # [B, k]

    take_all = (n_c <= k)[:, None]
    off_draw = bits % n_c.clamp(min=1)[:, None]
    off_seq = torch.minimum(lane[None, :], (n_c - 1).clamp(min=0)[:, None])
    off = torch.where(take_all, off_seq, off_draw)
    flat = (start[:, None] + off).clamp(0, adj.indices.shape[0] - 1)
    rows = adj.indices.long()[flat]                             # [B, k]

    alive = ((dst >= 0) & (n_c > 0))[:, None]
    alive = alive & (~take_all | (lane[None, :] < n_c[:, None]))

    ncf = n_c.float().clamp(min=1.0)[:, None]
    hitp = adj.hitp[rows.clamp(min=0)]
    coeff = (hitp * (ncf.clamp(max=float(k)) / ncf)).clamp(min=1e-6)
    deg = adj.deg[rowc].clamp(min=1.0)[:, None]
    w = torch.where(alive, 1.0 / (coeff * deg), 0.0)
    rows = torch.where(alive, rows, -1)
    return rows.to(torch.int32), w


def sample_lanes_plain(adj: DeviceCacheAdj, dst_rows: torch.Tensor,
                       fb_rows: torch.Tensor, fb_w: torch.Tensor,
                       key) -> tuple[torch.Tensor, torch.Tensor]:
    """The merged layer-0 lanes ``(lane_rows int32, lane_w f32)`` [B, k]:
    the draw for cached destinations, the fallback lanes for the rest."""
    drawn, w = draw_lanes_plain(adj, dst_rows, key, fb_rows.shape[1])
    uncached = (dst_rows < 0)[:, None]
    lane_rows = torch.where(uncached, fb_rows.to(torch.int32), drawn)
    lane_w = torch.where(uncached, fb_w.float(), w)
    return lane_rows, lane_w


def gns_sample_agg_plain(adj: DeviceCacheAdj, cache_table: torch.Tensor,
                         dst_rows: torch.Tensor, fb_rows: torch.Tensor,
                         fb_w: torch.Tensor, key, row_lo: int = 0,
                         row_count: int | None = None) -> torch.Tensor:
    """Draw, merge and gather in plain PyTorch, from the table rows
    ``[row_lo, row_lo + row_count)`` that ``cache_table`` holds (default:
    all of them).  [B, D] f32."""
    lane_rows, lane_w = sample_lanes_plain(adj, dst_rows, fb_rows, fb_w, key)
    if row_count is None:
        row_count = adj.table_rows
    if row_count == 0:               # an empty shard: nothing to gather
        return torch.zeros((dst_rows.shape[0], cache_table.shape[1]),
                           dtype=torch.float32, device=cache_table.device)
    mine = (lane_rows >= row_lo) & (lane_rows < row_lo + row_count)
    return slot_gather_agg_plain(cache_table,
                                 torch.where(mine, lane_rows - row_lo, -1),
                                 torch.where(mine, lane_w, 0.0))


def gns_sample_agg_cuda(adj: DeviceCacheAdj, cache_table: torch.Tensor,
                        dst_rows: torch.Tensor, fb_rows: torch.Tensor,
                        fb_w: torch.Tensor, key,
                        lane_rows: torch.Tensor | None = None,
                        lane_w: torch.Tensor | None = None, row_lo: int = 0,
                        row_count: int | None = None) -> torch.Tensor:
    """Launch K3.  adj on the table's CUDA device (indptr/indices int32,
    deg/hitp f32), table [row_count, D] f32/bf16 holding the rows
    ``[row_lo, row_lo + row_count)`` of the CSR's ``adj.table_rows``
    (default: all of them), dst_rows [B] int32, fb_rows/fb_w [B, k]
    int32/f32 with 1 <= k <= 32, all contiguous -> [B, D] f32.
    ``lane_rows``/``lane_w`` ([B, k] int32/f32), when given, receive the
    merged lanes (global rows, whatever the range)."""
    if not cache_table.is_cuda:
        raise ValueError(f"gns_sample_agg_cuda needs CUDA tensors, got "
                         f"{cache_table.device}")
    dev = cache_table.device
    check_rows("cache_table", cache_table, dev, TABLE_DTYPES, 2)
    check_rows("indptr", adj.indptr, dev, (torch.int32,), 1)
    check_rows("indices", adj.indices, dev, (torch.int32,), 1)
    check_rows("deg", adj.deg, dev, (torch.float32,), 1)
    check_rows("hitp", adj.hitp, dev, (torch.float32,), 1)
    check_rows("dst_rows", dst_rows, dev, (torch.int32,), 1)
    check_rows("fb_rows", fb_rows, dev, (torch.int32,), 2)
    check_rows("fb_w", fb_w, dev, (torch.float32,), 2)
    bsz, k = fb_rows.shape
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"K3 draws 1..{MAX_LANES} lanes per row, got {k}")
    rows = adj.table_rows
    if row_count is None:
        row_count = rows
    if adj.deg.shape[0] != rows or adj.hitp.shape[0] != rows:
        raise ValueError(f"deg {adj.deg.shape[0]}, hitp "
                         f"{adj.hitp.shape[0]}: expected the CSR's {rows}")
    if cache_table.shape[0] != row_count or not (
            0 <= row_lo and row_lo + row_count <= rows):
        raise ValueError(f"table {cache_table.shape[0]} rows for the range "
                         f"[{row_lo}, {row_lo + row_count}) of the CSR's "
                         f"{rows}")
    if dst_rows.shape[0] != bsz or fb_w.shape != fb_rows.shape:
        raise ValueError(f"dst_rows {tuple(dst_rows.shape)}, fb_rows "
                         f"{tuple(fb_rows.shape)}, fb_w {tuple(fb_w.shape)}")
    write_lanes = lane_rows is not None or lane_w is not None
    if write_lanes:
        check_rows("lane_rows", lane_rows, dev, (torch.int32,), 2)
        check_rows("lane_w", lane_w, dev, (torch.float32,), 2)
        if lane_rows.shape != fb_rows.shape or lane_w.shape != fb_rows.shape:
            raise ValueError("lane_rows/lane_w must have fb_rows' shape")
    else:
        lane_rows = torch.empty(0, dtype=torch.int32, device=dev)
        lane_w = torch.empty(0, dtype=torch.float32, device=dev)
    out = torch.empty((bsz, cache_table.shape[1]), dtype=torch.float32,
                      device=dev)
    key_lo, key_hi = key_words(key)
    if out.numel():                  # an empty grid is not a valid launch
        path = access_path(cache_table)
        load_kernels().gns_sample_agg(
            *adj.tensors(), cache_table, dst_rows, fb_rows, fb_w, key_lo,
            key_hi, out, lane_rows, lane_w, write_lanes, row_lo, row_count,
            path == "vector", 0)     # 0: the kernel's own tile plan
        # one count per eager call; a captured step would count once per
        # capture, so the capture must count its replays itself
        launches.add()  # gnscheck: ignore[trace-mutation]
        path_calls[path].add()
    return out


def gns_sample_agg(adj: DeviceCacheAdj, cache_table: torch.Tensor,
                   dst_rows: torch.Tensor, fb_rows: torch.Tensor,
                   fb_w: torch.Tensor, key, *, mesh=None,
                   shard_axis: str | None = None) -> torch.Tensor:
    """The device GNS input layer: draw + weight + gather.  [B, D] f32.

    ``dst_rows`` is the batch's ``input_cache_slots`` (device rows of the
    destinations, -1 for uncached rows and padding); ``fb_rows``/``fb_w``
    are the host-sampled fallback lanes of uncached real destinations.
    With ``mesh`` and ``shard_axis``, ``cache_table`` is this rank's shard
    and its partial is all-reduced over the cache group.  Forward only:
    raises ``NotImplementedError`` if an operand requires grad.
    """
    operands = (cache_table, dst_rows, fb_rows, fb_w) + adj.tensors()
    if any(t.requires_grad for t in operands):
        raise NotImplementedError(
            "gns_sample_agg is forward only (the reference stops the "
            "gradient at every operand): pass detached tensors")
    rng = {}
    sharded = (mesh is not None and shard_axis in mesh.axis_names
               and mesh.shape[shard_axis] > 1)
    if sharded:
        rps = cache_table.shape[0]
        rng = {"row_lo": mesh.index(shard_axis) * rps, "row_count": rps}
    run = gns_sample_agg_cuda if cache_table.is_cuda else gns_sample_agg_plain
    out = run(adj, cache_table, dst_rows, fb_rows, fb_w, key, **rng)
    return ops.psum(out, mesh, shard_axis) if sharded else out
