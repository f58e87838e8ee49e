"""Named synthetic datasets replicating the *shape* of paper Table 2.

Each entry scales the paper's dataset down (container is 1 core / 35 GB) while
preserving the quantities that drive GNS behavior: average degree, feature
dimension, train fraction, and number of classes.  ``scale`` multiplies node
counts; the default configs are sized for CI-speed tests and the benchmark
harness bumps them up.

Paper Table 2 (original → synthetic default):
  Yelp              716,847 nodes, avg deg 10, feat 300, 100 cls, 75% train → 72k nodes
  Amazon          1,598,960 nodes, avg deg 83, feat 200, 107 cls, 85% train → 40k nodes (deg 40)
  OAG-paper      15,257,994 nodes, avg deg 14, feat 768, 146 cls, 43% train → 60k nodes
  OGBN-products   2,449,029 nodes, avg deg 51, feat 100,  47 cls, 10% train → 61k nodes
  OGBN-papers100M 111M nodes,     avg deg 30, feat 128, 172 cls,  1% train → 100k nodes
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.generate import sbm_graph, node_features_from_labels


@dataclasses.dataclass
class GraphDataset:
    name: str
    graph: CSRGraph
    features: np.ndarray       # float32 [V, F]  (host feature store)
    labels: np.ndarray         # int32 [V]
    train_idx: np.ndarray      # int64
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]


@dataclasses.dataclass(frozen=True)
class _Spec:
    nodes: int
    avg_deg: float
    feat: int
    classes: int
    train_frac: float
    val_frac: float


# name -> (scaled default spec); classes capped at 32 to keep one-hot cheap.
DATASETS: dict[str, _Spec] = {
    "yelp":          _Spec(nodes=72_000,  avg_deg=10, feat=300, classes=32, train_frac=0.75, val_frac=0.10),
    "amazon":        _Spec(nodes=40_000,  avg_deg=40, feat=200, classes=32, train_frac=0.85, val_frac=0.05),
    "oag-paper":     _Spec(nodes=60_000,  avg_deg=14, feat=768, classes=32, train_frac=0.43, val_frac=0.05),
    "ogbn-products": _Spec(nodes=61_000,  avg_deg=51, feat=100, classes=32, train_frac=0.10, val_frac=0.02),
    "ogbn-papers":   _Spec(nodes=100_000, avg_deg=30, feat=128, classes=32, train_frac=0.01, val_frac=0.001),
    # tiny config for unit tests
    "tiny":          _Spec(nodes=2_000,   avg_deg=8,  feat=32,  classes=8,  train_frac=0.5,  val_frac=0.1),
}


def get_dataset(name: str, scale: float = 1.0, seed: int = 0) -> GraphDataset:
    spec = DATASETS[name]
    n = max(int(spec.nodes * scale), 256)
    g, labels = sbm_graph(n, num_blocks=spec.classes, avg_degree=spec.avg_deg,
                          seed=seed)
    feats = node_features_from_labels(labels, spec.feat, noise=1.5, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    perm = rng.permutation(n)
    n_tr = int(n * spec.train_frac)
    n_va = max(int(n * spec.val_frac), 1)
    return GraphDataset(
        name=name, graph=g, features=feats, labels=labels,
        train_idx=np.sort(perm[:n_tr]),
        val_idx=np.sort(perm[n_tr:n_tr + n_va]),
        test_idx=np.sort(perm[n_tr + n_va:]),
        num_classes=spec.classes,
    )
