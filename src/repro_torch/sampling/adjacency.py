"""Each generation's cached-neighbor CSR over device-table rows (port of
``repro.sampling.adjacency``).

The host :class:`~repro_torch.graph.csr.CacheAdjacency` spans the full
node-id space.  The device sampler only starts from rows of the device
cache table, so its CSR is indexed by **device rows** (the placement
permutation of the generation): row ``r`` of the table is row ``r`` of the
CSR, and its list holds the device rows of its cached neighbors.  The
layer-0 draw is then a computation on table rows alone.

Built once per generation in numpy (``FeatureStore._build``), uploaded with
the table and carried on ``Generation.device_adj``, so a batch sampled
against generation *g* draws from *g*'s CSR and gathers *g*'s rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.importance import cache_hit_prob
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DeviceCacheAdj:
    """The per-generation CSR over cache-table rows, as four tensors.

    ``indices`` is padded to a power-of-two capacity (at least 1024), as
    the reference pads it.
    """
    indptr: torch.Tensor   # int32 [table_rows + 1]  device-row order
    indices: torch.Tensor  # int32 [cap]  neighbor DEVICE rows (pad = 0)
    deg: torch.Tensor      # f32 [table_rows]  full-graph degree of the
                           # row's node (eq. 10's deg(v); 0 for pad rows)
    hitp: torch.Tensor     # f32 [table_rows]  cache-inclusion probability
                           # p_u^C of the row's node (eq. 11 / calibrated λ)

    @property
    def table_rows(self) -> int:
        return self.indptr.shape[0] - 1

    def tensors(self) -> tuple:
        return (self.indptr, self.indices, self.deg, self.hitp)


def build_device_cache_adj(state, host_adj, degrees: np.ndarray, lam=None,
                           meter=None, device=None) -> DeviceCacheAdj:
    """One generation's device CSR, built in numpy and uploaded once.

    ``state`` is the generation's ``CacheState``, ``host_adj`` the induced
    cached-neighbor CSR over the full id space, ``degrees`` the full-graph
    degree per node and ``lam`` the generation's calibrated inclusion λ
    (None = eq. 11).  The hit probabilities are computed per row in float64
    and stored as f32.  The four arrays go to ``device`` (``None``: the
    GPU), each as a copy (never a view of numpy memory), and a CUDA upload
    is synchronised before this returns, so the generation that carries it
    is published complete.  ``meter.bytes_adj_upload`` receives the bytes.
    """
    rows = state.table_rows if state.table_rows else state.size
    dr = state.device_rows(np.arange(state.size))
    node_of_row = np.full(rows, -1, dtype=np.int64)
    node_of_row[dr] = state.node_ids
    occ = node_of_row >= 0
    nodes = node_of_row[occ]

    counts = np.zeros(rows, dtype=np.int64)
    counts[occ] = host_adj.indptr[nodes + 1] - host_adj.indptr[nodes]
    indptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])

    # flat ragged gather: row r's slice of the host CSR, in device-row order
    rep = np.repeat(np.arange(rows), counts)
    off = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], counts)
    starts = host_adj.indptr[np.maximum(node_of_row, 0)]
    nbr_ids = host_adj.indices[starts[rep] + off]
    # a cached node's induced neighbors are cached by construction, so the
    # device-row map is total
    nbr_rows = state.device_rows(state.slot_of[nbr_ids]).astype(np.int32)

    cap = max(1024, nnz)
    cap = 1 << (cap - 1).bit_length()
    indices = np.zeros(cap, dtype=np.int32)
    indices[:nnz] = nbr_rows

    deg = np.zeros(rows, dtype=np.float32)
    deg[occ] = degrees[nodes]
    hitp = np.zeros(rows, dtype=np.float32)
    hitp[occ] = cache_hit_prob(state.probs[nodes], state.size, lam=lam)
    arrays = {"indptr": indptr.astype(np.int32), "indices": indices,
              "deg": deg, "hitp": hitp}
    dev = resolve_device(device)
    adj = DeviceCacheAdj(**{k: torch.from_numpy(a).to(dev, copy=True)
                            for k, a in arrays.items()})
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    if meter is not None:
        meter.bytes_adj_upload += sum(a.nbytes for a in arrays.values())
    return adj
