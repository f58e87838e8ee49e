"""Deterministic delta-CSR merge: fold buffered deltas into a host CSR (port
of ``repro.stream.merge``, bitwise equal to it).

The contract that makes streaming ingest safe to serve through the existing
generation machinery is **rebuild equivalence**: for any delta batch,

    merge_delta_csr(g, batch)  ==  CSRGraph.from_edges(post-merge edge set)

bitwise — same ``indptr`` (int64), same ``indices`` (int32), same per-row
sorted order.  ``FeatureStore._build`` can then materialize the post-merge
structure (induced cache adjacency, eq.-11 probabilities, DeviceCacheAdj)
exactly as if the graph had been loaded that way, and the atomic generation
swap carries structure the same way it carries features.

The merge itself never re-sorts the old edge set: both the existing CSR and
the effective delta are expressed as globally ascending ``row * V + col``
keys (rows are indptr-grouped, within-row indices sorted — the
``from_edges`` invariant), so deletions are a sorted-membership mask and
insertions are a positional scatter at ``searchsorted`` offsets —
O(E + Δ log E) instead of the O(E log E) full rebuild.

Delta semantics (matching :class:`~repro_torch.stream.delta.DeltaBuffer`):

* ops apply in **sequence order**; the last op on an edge key wins, so
  delete-then-insert inside one batch lands inserted, insert-then-delete
  lands absent;
* with ``symmetrize`` each op mirrors to both directions (the undirected
  convention of ``CSRGraph.from_edges``);
* self-loops are dropped, duplicate inserts of an existing edge are no-ops
  (idempotent), deletes of absent edges are no-ops;
* new nodes extend the id space by ``batch.num_new_nodes`` empty rows;
  every id referenced by an op must be below the post-merge node count.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def _effective_ops(batch, num_nodes: int, symmetrize: bool
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Collapse the op log to (sorted unique edge keys, winning op per key).

    Keys are ``src * num_nodes + dst`` in the POST-merge id space.  The
    winner per key is the op with the highest sequence number (mirrored ops
    share their original's seq — both directions of one logical op always
    agree, so the tie is harmless).
    """
    src = np.asarray(batch.edge_src, dtype=np.int64)
    dst = np.asarray(batch.edge_dst, dtype=np.int64)
    op = np.asarray(batch.edge_op, dtype=np.int8)
    seq = np.asarray(batch.edge_seq, dtype=np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        op, seq = np.concatenate([op, op]), np.concatenate([seq, seq])
    keep = src != dst
    src, dst, op, seq = src[keep], dst[keep], op[keep], seq[keep]
    if not len(src):
        return np.zeros(0, np.int64), np.zeros(0, np.int8)
    assert int(src.max()) < num_nodes and int(dst.max()) < num_nodes, (
        "delta op references a node id beyond the post-merge id space — "
        "stage new nodes through DeltaBuffer.add_nodes first")
    assert int(src.min()) >= 0 and int(dst.min()) >= 0
    key = src * num_nodes + dst
    order = np.lexsort((seq, key))          # grouped by key, seq ascending
    key, op = key[order], op[order]
    last = np.ones(len(key), dtype=bool)    # last occurrence per key group
    last[:-1] = key[1:] != key[:-1]
    return key[last], op[last]


def merge_delta_csr(graph: CSRGraph, batch, *,
                    symmetrize: bool = True) -> CSRGraph:
    """Apply one drained :class:`~repro_torch.stream.delta.DeltaBatch` to ``graph``.

    Returns a NEW :class:`CSRGraph` over ``graph.num_nodes +
    batch.num_new_nodes`` ids, bitwise-equal to rebuilding from the
    post-merge edge set (module docstring).  The input graph is never
    mutated — generations pinned to it keep sampling it unchanged.
    """
    v_new = graph.num_nodes + int(batch.num_new_nodes)
    eff_key, eff_op = _effective_ops(batch, v_new, symmetrize)

    # existing edges as globally ascending keys in the NEW id space (row
    # blocks are indptr-ordered and within-row sorted, so the flattened key
    # sequence is strictly increasing — no sort needed)
    row_of_edge = np.repeat(np.arange(graph.num_nodes, dtype=np.int64),
                            graph.degrees)
    old_keys = row_of_edge * v_new + graph.indices.astype(np.int64)

    del_keys = eff_key[eff_op < 0]
    if len(del_keys):
        # sorted-membership mask: an old edge survives unless deleted
        pos = np.searchsorted(del_keys, old_keys)
        pos = np.minimum(pos, len(del_keys) - 1)
        kept = old_keys[del_keys[pos] != old_keys]
    else:
        kept = old_keys

    ins_keys = eff_key[eff_op > 0]
    if len(ins_keys) and len(kept):
        # idempotence: inserting an edge that already exists is a no-op
        pos = np.searchsorted(kept, ins_keys)
        pos = np.minimum(pos, len(kept) - 1)
        ins_keys = ins_keys[kept[pos] != ins_keys]
    if len(ins_keys):
        # positional scatter: both sides sorted, so the merged key sequence
        # is the sorted union without a global re-sort
        at = np.searchsorted(kept, ins_keys) + np.arange(len(ins_keys))
        merged = np.empty(len(kept) + len(ins_keys), dtype=np.int64)
        new_slot = np.zeros(len(merged), dtype=bool)
        new_slot[at] = True
        merged[new_slot] = ins_keys
        merged[~new_slot] = kept
    else:
        merged = kept

    indptr = np.zeros(v_new + 1, dtype=np.int64)
    np.add.at(indptr, merged // v_new + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRGraph(indptr=indptr,
                    indices=(merged % v_new).astype(np.int32))
