"""Immutable CSR graph storage (host side).

The GNS paper keeps the full graph topology and node features in CPU memory and
samples minibatches there (mixed CPU-GPU training, §2.2).  This mirrors DGL's
in-memory CSR: ``indptr`` (int64, |V|+1) and ``indices`` (int32, |E|).

All sampler-facing operations are vectorized numpy; nothing here touches torch,
so importing this module never initializes a device backend.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Out-neighbor CSR.  For undirected graphs store both edge directions."""

    indptr: np.ndarray   # int64 [num_nodes + 1]
    indices: np.ndarray  # int32 [num_edges]

    def __post_init__(self):
        assert self.indptr.ndim == 1 and self.indices.ndim == 1
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   symmetrize: bool = True, dedup: bool = True) -> "CSRGraph":
        """Build CSR from an edge list.  O(E log E), fully vectorized."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        # drop self loops
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if dedup:
            key = src * num_nodes + dst
            key = np.unique(key)
            src, dst = key // num_nodes, key % num_nodes
        else:
            order = np.argsort(src, kind="stable")
            src, dst = src[order], dst[order]
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRGraph(indptr=indptr, indices=dst.astype(np.int32))

    # ------------------------------------------------------------------
    # Batched neighbor access (sampler hot path)
    # ------------------------------------------------------------------
    def sample_neighbors(self, nodes: np.ndarray, k: int,
                         rng: np.random.Generator,
                         replace: Optional[bool] = None) -> tuple[np.ndarray, np.ndarray]:
        """Uniformly sample up to ``k`` neighbors for each node in ``nodes``.

        Returns ``(nbrs, mask)`` of shape (len(nodes), k), int32/bool.  Nodes
        with degree ``<= k`` get their full neighbor list (no replacement) and
        the remaining lanes masked out — matching DGL's ``sample_neighbors``
        semantics used by the paper's NS baseline.  Padded lanes hold 0.
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        deg = self.indptr[nodes + 1] - self.indptr[nodes]
        n = len(nodes)
        out = np.zeros((n, k), dtype=np.int32)
        mask = np.zeros((n, k), dtype=bool)

        # --- nodes with deg <= k: copy all neighbors (vectorized ragged copy)
        small = deg <= k
        if small.any():
            sn = nodes[small]
            sdeg = deg[small]
            # ragged -> padded via a flat gather
            starts = self.indptr[sn]
            lane = np.arange(k)[None, :]
            src_idx = starts[:, None] + np.minimum(lane, np.maximum(sdeg - 1, 0)[:, None])
            # isolated nodes (deg 0) produce an OOB flat index; clamp — the
            # mask discards the gathered value.
            src_idx = np.minimum(src_idx, max(len(self.indices) - 1, 0))
            vals = self.indices[src_idx]
            m = lane < sdeg[:, None]
            rows = np.where(small)[0]
            out[rows] = np.where(m, vals, 0)
            mask[rows] = m

        # --- nodes with deg > k: sample k offsets without replacement
        big = ~small
        if big.any():
            bn = nodes[big]
            bdeg = deg[big]
            rows = np.where(big)[0]
            # Vectorized sampling without replacement via argpartition of
            # random keys: generate (m, k) unique offsets per row using the
            # Floyd-ish trick — random floats ranked per row.
            # For rows with huge degree this is O(m*k) not O(m*deg).
            r = rng.random((len(bn), k))
            # map k uniform draws onto distinct offsets: draw k floats, scale
            # to deg, resolve collisions by re-draw for the (rare) duplicates.
            offs = (r * bdeg[:, None]).astype(np.int64)
            # resolve duplicates within each row (cheap loop, rare)
            for _ in range(4):
                srt = np.sort(offs, axis=1)
                dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
                if not dup.any():
                    break
                ridx = np.where(dup)[0]
                offs[ridx] = (rng.random((len(ridx), k)) * bdeg[ridx][:, None]).astype(np.int64)
            else:
                # fall back to exact per-row choice for stubborn rows
                ridx = np.where((np.sort(offs, 1)[:, 1:] == np.sort(offs, 1)[:, :-1]).any(1))[0]
                for i in ridx:
                    offs[i] = rng.choice(bdeg[i], size=k, replace=False)
            out[rows] = self.indices[self.indptr[bn][:, None] + offs]
            mask[rows] = True
        return out, mask

    def induced_cache_adjacency(self, cache_mask: np.ndarray) -> "CacheAdjacency":
        """Precompute, for every node, its neighbors that fall in the cache.

        This is the paper's induced subgraph S (§3.3): built once per cache
        refresh so that per-minibatch 'neighbors ∩ cache' queries are O(1)
        lookups instead of O(deg) scans.  Returns a CSR over the same node id
        space whose adjacency lists contain only cached neighbors.
        """
        in_cache = cache_mask[self.indices]          # bool [E]
        counts = np.zeros(self.num_nodes, dtype=np.int64)
        # segment count of cached neighbors per node
        seg = np.repeat(np.arange(self.num_nodes), self.degrees)
        np.add.at(counts, seg[in_cache], 1)
        new_indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=new_indptr[1:])
        new_indices = self.indices[in_cache].astype(np.int32)
        return CacheAdjacency(indptr=new_indptr, indices=new_indices)


@dataclasses.dataclass(frozen=True)
class CacheAdjacency(CSRGraph):
    """CSR holding only cached neighbors — the induced subgraph S of §3.3."""
