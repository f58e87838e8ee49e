"""DeltaBuffer — thread-safe staging log for streaming graph mutations (port
of ``repro.stream.delta``).

The ingest half of the streaming subsystem: producers (request handlers, the
temporal-event replay, ``engine.ingest()``) append edge insertions/deletions
and new-node feature rows HERE, concurrently with training and serving; the
:class:`~repro_torch.featurestore.FeatureStore` drains the buffer exactly once per
generation build and folds the drained :class:`DeltaBatch` into the host CSR
(:func:`~repro_torch.stream.merge.merge_delta_csr`) before scoring/drawing the new
generation — so structure changes only ever publish through the atomic swap.

Discipline mirrors the serving tier:

* **bounded admission** — ops staged beyond ``max_pending`` raise
  :class:`~repro_torch.serve.server.QueueFull` (same exception class, so callers
  reuse one backpressure handler);
* **monotonic sequence numbers** — every edge op gets the next ``seq``;
  the merge resolves conflicting ops on one edge by highest seq
  (last-op-wins), and ``DeltaBatch.first_seq``/``last_seq`` give drains a
  total order;
* **`@guarded_by` annotations** — the same lock contract as the
  store/server, checked at run time by the sanitizer of
  :mod:`repro_torch.analysis`.

New nodes: :meth:`add_nodes` allocates the next contiguous id range (the
post-merge id space grows by exactly the staged rows) and stages their
feature/label rows; edges may reference the new ids immediately — they
become queryable once the merge publishes.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np

from repro_torch.analysis import guarded_by, holds_lock


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One drained, immutable slice of the op log (the merge input)."""
    edge_src: np.ndarray            # int64 [n_ops]
    edge_dst: np.ndarray            # int64 [n_ops]
    edge_op: np.ndarray             # int8 [n_ops]  +1 insert | -1 delete
    edge_seq: np.ndarray            # int64 [n_ops] monotonic
    node_feats: Optional[np.ndarray]    # f32 [n_new, F] | None
    node_labels: Optional[np.ndarray]   # int64 [n_new] | None
    node_base: int                  # first new node id (== pre-merge V)
    first_seq: int
    last_seq: int

    @property
    def num_ops(self) -> int:
        return len(self.edge_src)

    @property
    def num_new_nodes(self) -> int:
        return 0 if self.node_feats is None else len(self.node_feats)

    @property
    def payload_bytes(self) -> int:
        """Staged bytes this batch carries across the ingest boundary
        (``TrafficMeter.bytes_delta_upload``)."""
        n = (self.edge_src.nbytes + self.edge_dst.nbytes
             + self.edge_op.nbytes + self.edge_seq.nbytes)
        if self.node_feats is not None:
            n += self.node_feats.nbytes
        if self.node_labels is not None:
            n += self.node_labels.nbytes
        return int(n)


@guarded_by("_lock", "_src", "_dst", "_op", "_seq", "_feats", "_labels",
            "_next_node", "_next_seq", "_pending",
            writes_only=("admitted", "rejected", "drains"))
class DeltaBuffer:
    """Bounded, seq-stamped staging log of graph deltas (module docstring)."""

    def __init__(self, num_nodes: int, feat_dim: int, *,
                 max_pending: int = 4096):
        self.max_pending = int(max_pending)
        self.feat_dim = int(feat_dim)
        self._lock = threading.Lock()
        self._src: List[np.ndarray] = []
        self._dst: List[np.ndarray] = []
        self._op: List[np.ndarray] = []
        self._seq: List[np.ndarray] = []
        self._feats: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._next_node = int(num_nodes)    # post-merge id space high-water
        self._next_seq = 0
        self._pending = 0                   # staged ops + staged node rows
        self.admitted = 0
        self.rejected = 0
        self.drains = 0

    # ------------------------------------------------------------------
    @holds_lock("_lock")
    def _admit_locked(self, n: int) -> None:
        # imported here: repro_torch.serve's package __init__ pulls the
        # engine's config, which must stay importable while
        # repro_torch.stream is mid-import
        from repro_torch.serve.server import QueueFull
        if self._pending + n > self.max_pending:
            self.rejected += n
            raise QueueFull(
                f"delta buffer at capacity ({self._pending}/"
                f"{self.max_pending} staged ops): merge a generation before "
                f"ingesting more")

    def _stage_edges(self, src, dst, op: int) -> int:
        src = np.atleast_1d(np.asarray(src, dtype=np.int64))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int64))
        assert src.shape == dst.shape and src.ndim == 1, (src.shape, dst.shape)
        n = len(src)
        if n == 0:
            with self._lock:
                return self._next_seq
        with self._lock:
            self._admit_locked(n)
            hi = max(int(src.max()), int(dst.max()))
            lo = min(int(src.min()), int(dst.min()))
            assert 0 <= lo and hi < self._next_node, (
                f"edge op references node {hi} outside the staged id space "
                f"[0, {self._next_node}) — add_nodes first")
            first = self._next_seq
            self._src.append(src)
            self._dst.append(dst)
            self._op.append(np.full(n, op, dtype=np.int8))
            self._seq.append(np.arange(first, first + n, dtype=np.int64))
            self._next_seq = first + n
            self._pending += n
            self.admitted += n
        return first

    # ------------------------------------------------------------------
    # producer API
    # ------------------------------------------------------------------
    def add_edges(self, src, dst) -> int:
        """Stage edge insertions; returns the first assigned seq."""
        return self._stage_edges(src, dst, +1)

    def delete_edges(self, src, dst) -> int:
        """Stage edge deletions; returns the first assigned seq."""
        return self._stage_edges(src, dst, -1)

    def add_nodes(self, feats: np.ndarray,
                  labels: Optional[np.ndarray] = None) -> np.ndarray:
        """Stage new nodes with their feature rows; returns their ids.

        Ids are allocated contiguously from the current post-merge id
        space, so staged edges may reference them immediately; the rows
        land in the feature/label tiers at the next merge.
        """
        feats = np.asarray(feats, dtype=np.float32)
        if feats.ndim == 1:
            feats = feats[None, :]
        assert feats.shape[1] == self.feat_dim, (feats.shape, self.feat_dim)
        n = len(feats)
        if labels is not None:
            labels = np.atleast_1d(np.asarray(labels, dtype=np.int64))
            assert len(labels) == n, (len(labels), n)
        with self._lock:
            self._admit_locked(n)
            base = self._next_node
            self._feats.append(feats)
            self._labels.append(labels if labels is not None
                                else np.zeros(n, dtype=np.int64))
            self._next_node = base + n
            self._pending += n
            self.admitted += n
        return np.arange(base, base + n, dtype=np.int64)

    # ------------------------------------------------------------------
    # consumer API (the store's generation build)
    # ------------------------------------------------------------------
    def pending(self) -> int:
        """Staged ops + node rows awaiting a merge."""
        with self._lock:
            return self._pending

    @property
    def next_node(self) -> int:
        """The post-merge node-id high-water mark (pre-merge V + staged)."""
        with self._lock:
            return self._next_node

    @property
    def next_seq(self) -> int:
        """The next edge op's seq."""
        with self._lock:
            return self._next_seq

    def follow(self, next_node: int, next_seq: int) -> None:
        """Take another buffer's id and seq clocks (never rewinding): on a
        mesh the ranks that stage nothing follow the leader's, so every
        rank's clocks agree after a merge or a restore."""
        with self._lock:
            self._next_node = max(self._next_node, int(next_node))
            self._next_seq = max(self._next_seq, int(next_seq))

    # ------------------------------------------------------------------
    # checkpoint surface (repro_torch.checkpoint aux payload)
    # ------------------------------------------------------------------
    def state(self) -> dict:
        """Snapshot the staged-but-unmerged log for checkpointing.

        Returns a dict of flat numpy arrays plus the id/seq high-water
        marks — exactly what :meth:`restore` consumes.  The snapshot is
        taken atomically, so a save that races with producers captures a
        consistent seq prefix.
        """
        with self._lock:
            feats = (np.concatenate(self._feats) if self._feats
                     else np.zeros((0, self.feat_dim), np.float32))
            labels = (np.concatenate(self._labels) if self._labels
                      else np.zeros(0, np.int64))
            return {
                "edge_src": (np.concatenate(self._src) if self._src
                             else np.zeros(0, np.int64)),
                "edge_dst": (np.concatenate(self._dst) if self._dst
                             else np.zeros(0, np.int64)),
                "edge_op": (np.concatenate(self._op) if self._op
                            else np.zeros(0, np.int8)),
                "edge_seq": (np.concatenate(self._seq) if self._seq
                             else np.zeros(0, np.int64)),
                "node_feats": feats,
                "node_labels": labels,
                "next_node": np.int64(self._next_node),
                "next_seq": np.int64(self._next_seq),
            }

    def restore(self, state: dict) -> None:
        """Adopt a checkpointed staging log (inverse of :meth:`state`).

        REPLACES whatever is currently staged — restore-then-restore is a
        no-op (idempotent), and replaying a snapshot whose ops were already
        merged is safe because the merge resolves per-edge conflicts by
        highest seq (last-op-wins): re-applied ops carry their original
        seqs, so they can never override anything staged after them.
        """
        src = np.asarray(state["edge_src"], dtype=np.int64)
        dst = np.asarray(state["edge_dst"], dtype=np.int64)
        op = np.asarray(state["edge_op"], dtype=np.int8)
        seq = np.asarray(state["edge_seq"], dtype=np.int64)
        feats = np.asarray(state["node_feats"], dtype=np.float32)
        labels = np.asarray(state["node_labels"], dtype=np.int64)
        assert src.shape == dst.shape == op.shape == seq.shape, (
            src.shape, dst.shape, op.shape, seq.shape)
        assert feats.ndim == 2 and feats.shape[1] == self.feat_dim, (
            feats.shape, self.feat_dim)
        next_seq = int(state["next_seq"])
        next_node = int(state["next_node"])
        if len(seq):
            assert next_seq > int(seq.max()), (next_seq, int(seq.max()))
        with self._lock:
            self._src = [src] if len(src) else []
            self._dst = [dst] if len(dst) else []
            self._op = [op] if len(op) else []
            self._seq = [seq] if len(seq) else []
            self._feats = [feats] if len(feats) else []
            self._labels = [labels] if len(feats) else []
            # never rewind the seq/id clocks: a snapshot older than what
            # this buffer already handed out must not recycle seqs (the
            # last-op-wins guarantee depends on monotonicity)
            self._next_seq = max(self._next_seq, next_seq)
            self._next_node = max(self._next_node, next_node)
            self._pending = int(len(src) + len(feats))

    def drain(self) -> Optional[DeltaBatch]:
        """Atomically take everything staged (None when empty).

        The drained batch is immutable and seq-ordered; producers staging
        after the drain land in the NEXT batch/generation.
        """
        with self._lock:
            if self._pending == 0:
                return None
            src = (np.concatenate(self._src) if self._src
                   else np.zeros(0, np.int64))
            dst = (np.concatenate(self._dst) if self._dst
                   else np.zeros(0, np.int64))
            op = (np.concatenate(self._op) if self._op
                  else np.zeros(0, np.int8))
            seq = (np.concatenate(self._seq) if self._seq
                   else np.zeros(0, np.int64))
            feats = (np.concatenate(self._feats) if self._feats else None)
            labels = (np.concatenate(self._labels) if self._feats else None)
            n_new = 0 if feats is None else len(feats)
            batch = DeltaBatch(
                edge_src=src, edge_dst=dst, edge_op=op, edge_seq=seq,
                node_feats=feats, node_labels=labels,
                node_base=self._next_node - n_new,
                first_seq=int(seq[0]) if len(seq) else self._next_seq,
                last_seq=int(seq[-1]) if len(seq) else self._next_seq)
            self._src, self._dst, self._op, self._seq = [], [], [], []
            self._feats, self._labels = [], []
            self._pending = 0
            self.drains += 1
        return batch
