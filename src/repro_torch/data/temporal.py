"""Temporal event streams: the serve-while-mutating workload generator
(port of ``repro.data.temporal``; the same dataset and seed give the
reference's arrays).

GDELT-shaped replay for the streaming-ingest subsystem
(``repro_torch.stream``):
real event graphs arrive as timestamped batches of *interactions between
entities* — mostly between entities already known (with heavy-tailed,
preferential recurrence: hot actors stay hot), plus a trickle of new
entities that must become queryable shortly after they appear.

:func:`temporal_event_stream` synthesizes that shape on top of any loaded
:class:`~repro_torch.graph.datasets.GraphDataset`:

* event endpoints are drawn **preferentially by degree** (the recurrence
  skew that makes the GNS cache effective also concentrates ingest on hot
  rows — exactly the regime the incremental placement re-solve must absorb);
* each batch introduces ``new_node_frac`` new entities with feature/label
  rows, id-contiguous above the current space (matching
  ``DeltaBuffer.add_nodes`` allocation, so batches replay in order via
  ``engine.ingest_events``);
* every new entity is attached to at least one existing hot entity, so
  post-merge queries for it have neighbors to sample.

The stream is deterministic in ``seed`` — replaying it against a rebuilt
engine reproduces the same post-merge structure bit for bit (the merge
kernel's rebuild-equivalence contract extends end to end).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class EventBatch:
    """One timestamped slice of the event stream (an ``ingest_events`` unit).

    ``src``/``dst`` are absolute node ids under the assumption batches are
    ingested IN ORDER: new entities of this batch occupy
    ``[node_base, node_base + len(node_feats))``, contiguous above
    everything staged before them.
    """
    t_start: int
    t_end: int
    src: np.ndarray                      # int64 [n_events]
    dst: np.ndarray                      # int64 [n_events]
    node_feats: Optional[np.ndarray]     # f32 [n_new, F] | None
    node_labels: Optional[np.ndarray]    # int64 [n_new] | None
    node_base: int                       # first new id (== id space before)

    @property
    def num_events(self) -> int:
        return len(self.src)

    @property
    def num_new_nodes(self) -> int:
        return 0 if self.node_feats is None else len(self.node_feats)


class TemporalEventStream:
    """An ordered, replayable sequence of :class:`EventBatch` (list-like)."""

    def __init__(self, batches: List[EventBatch], base_nodes: int):
        self.batches = batches
        self.base_nodes = int(base_nodes)   # id space before any batch

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[EventBatch]:
        return iter(self.batches)

    def __getitem__(self, i: int) -> EventBatch:
        return self.batches[i]

    @property
    def total_events(self) -> int:
        return sum(b.num_events for b in self.batches)

    @property
    def total_new_nodes(self) -> int:
        return sum(b.num_new_nodes for b in self.batches)


def temporal_event_stream(dataset, *, num_batches: int = 8,
                          events_per_batch: int = 64,
                          new_node_frac: float = 0.1,
                          seed: int = 0) -> TemporalEventStream:
    """Synthesize a GDELT-shaped event stream over ``dataset`` (module doc).

    ``new_node_frac`` is the fraction of each batch's events that introduce
    a brand-new entity (one new node + its attachment edge per such event).
    """
    g = dataset.graph
    feats = np.asarray(dataset.features)
    feat_dim = feats.shape[1]
    num_classes = int(dataset.num_classes)
    rng = np.random.default_rng(seed)

    # preferential-attachment weights: degree+1 for loaded entities; new
    # entities enter at the mean weight so they can recur in later batches
    w = np.asarray(g.degrees, dtype=np.float64) + 1.0
    mean_w = float(w.mean())
    next_node = int(g.num_nodes)
    feat_loc = feats.mean(axis=0)
    feat_scale = feats.std(axis=0) + 1e-6

    batches: List[EventBatch] = []
    for b in range(num_batches):
        n_new = max(1, int(round(events_per_batch * new_node_frac))) \
            if new_node_frac > 0 else 0
        n_rec = events_per_batch - n_new
        p = w / w.sum()
        # recurring interactions between known entities (hot ↔ hot skew)
        src = rng.choice(len(w), size=n_rec, p=p)
        dst = rng.choice(len(w), size=n_rec, p=p)
        # resample self-pairs once (the merge drops self-loops anyway; this
        # just keeps the event count honest)
        loop = src == dst
        dst[loop] = rng.choice(len(w), size=int(loop.sum()), p=p)
        node_feats = node_labels = None
        if n_new:
            base = next_node
            # new entities look like the loaded ones (feature marginals)
            node_feats = rng.normal(
                feat_loc, feat_scale, size=(n_new, feat_dim)
            ).astype(np.float32)
            node_labels = rng.integers(0, max(num_classes, 1),
                                       size=n_new, dtype=np.int64)
            # each new entity attaches to one existing (preferential) anchor
            anchors = rng.choice(len(w), size=n_new, p=p)
            src = np.concatenate([src, np.arange(base, base + n_new)])
            dst = np.concatenate([dst, anchors])
            next_node = base + n_new
            w = np.concatenate([w, np.full(n_new, mean_w)])
        batches.append(EventBatch(
            t_start=b * events_per_batch,
            t_end=(b + 1) * events_per_batch,
            src=src.astype(np.int64), dst=dst.astype(np.int64),
            node_feats=node_feats, node_labels=node_labels,
            node_base=int(next_node - n_new) if n_new
            else int(next_node)))
    return TemporalEventStream(batches, base_nodes=int(g.num_nodes))
