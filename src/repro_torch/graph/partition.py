"""Graph partitioning for multi-host pods.

At 1000+ nodes the full graph does not live in one host's RAM (papers100M
features alone are 57 GB).  We hash-partition node ids across hosts: each host
owns the CSR rows and the feature rows of its nodes.  The GNS cache refresh is
then a collective: every host samples its share of the cache (probability mass
restricted to owned nodes, properly renormalized) and all-gathers the cached
feature rows — after which *minibatch* feature traffic is mostly local cache
hits, which is exactly the paper's point applied at pod scale.

This module is host-side bookkeeping (numpy); the device-side dry-run models
the resulting per-chip tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass(frozen=True)
class Partition:
    """One host's shard of the graph."""
    host_id: int
    num_hosts: int
    owned: np.ndarray          # int64 node ids owned by this host (sorted)
    local_indptr: np.ndarray   # CSR over owned rows (indices are GLOBAL ids)
    local_indices: np.ndarray

    @property
    def num_owned(self) -> int:
        return len(self.owned)

    def owner_of(self, nodes: np.ndarray) -> np.ndarray:
        return nodes % self.num_hosts


def hash_partition(g: CSRGraph, num_hosts: int) -> list[Partition]:
    """Partition rows by ``node_id % num_hosts`` (DistDGL-style hash).

    Hash partitioning keeps the expected degree mass balanced on power-law
    graphs without a METIS pass (which would not scale to 100M nodes in this
    container anyway); the paper's own distributed follow-up (DistDGL) uses
    the same fallback.
    """
    parts = []
    all_ids = np.arange(g.num_nodes, dtype=np.int64)
    for h in range(num_hosts):
        owned = all_ids[all_ids % num_hosts == h]
        deg = g.indptr[owned + 1] - g.indptr[owned]
        local_indptr = np.zeros(len(owned) + 1, dtype=np.int64)
        np.cumsum(deg, out=local_indptr[1:])
        local_indices = np.empty(int(deg.sum()), dtype=np.int32)
        # ragged gather of each owned row
        pos = 0
        starts, ends = g.indptr[owned], g.indptr[owned + 1]
        # vectorized ragged copy
        total = int(deg.sum())
        if total:
            flat = np.concatenate([g.indices[s:e] for s, e in zip(starts, ends)]) \
                if len(owned) < 65536 else _ragged_gather(g.indices, starts, ends, total)
            local_indices[:] = flat
        parts.append(Partition(host_id=h, num_hosts=num_hosts, owned=owned,
                               local_indptr=local_indptr, local_indices=local_indices))
        del pos
    return parts


def _ragged_gather(indices: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                   total: int) -> np.ndarray:
    """Vectorized ragged row gather: builds a flat index without Python loops."""
    lens = ends - starts
    out_idx = np.repeat(starts, lens)
    # within-row offsets
    csum = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=csum[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(csum[:-1], lens)
    return indices[out_idx + within]


def cache_refresh_traffic_bytes(cache_size: int, feat_dim: int,
                                num_hosts: int, bytes_per_el: int = 4) -> int:
    """Bytes all-gathered per cache refresh at pod scale.

    Each host contributes ~cache_size/num_hosts rows and receives the rest —
    i.e. ring all-gather moves cache_size*feat_dim*(num_hosts-1)/num_hosts
    bytes per host.  Used by the roofline/§Perf accounting to show the refresh
    amortizes over P epochs (paper Table 6 shows P up to 5 is accuracy-neutral).
    """
    rows_recv = cache_size * (num_hosts - 1) // max(num_hosts, 1)
    return rows_recv * feat_dim * bytes_per_el
