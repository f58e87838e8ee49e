"""Synthetic giant-graph generators.

The paper evaluates on power-law graphs (Yelp, Amazon, OAG, OGBN-products,
OGBN-papers100M — Table 2).  The container cannot hold the real datasets, so we
generate graphs that replicate the properties the GNS mechanism depends on:

* heavy-tailed (power-law) degree distribution — makes a small degree-biased
  cache cover most edge endpoints (paper §3.2: "For a power-law graph, we only
  need to maintain a small cache of nodes to cover majority of the nodes");
* community structure + correlated labels (SBM) — so that *accuracy* of GNS vs
  NS vs LADIES is a meaningful comparison, not just throughput;
* configurable feature dim / train fraction matching Table 2 rows.

Everything is vectorized numpy; a 1M-node / 25M-edge graph generates in ~2 s.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def _powerlaw_degrees(n: int, avg_deg: float, alpha: float,
                      rng: np.random.Generator) -> np.ndarray:
    """Draw a degree sequence ~ Zipf(alpha) scaled to the requested mean.

    Hub cap: max(sqrt(n), 20*avg_deg) — a bare sqrt(n) cap amputates the
    tail on container-scale graphs (sqrt(9k) = 95 ~= 2x a degree-51 mean),
    which silently removes the hub-coverage property GNS's degree-biased
    cache depends on (paper §3.2).  The real OGBN graphs have max degree
    >> sqrt(n)-equivalent at small n (products: 17k at |V|=2.4M).
    """
    u = rng.random(n)
    raw = u ** (-1.0 / (alpha - 1.0))
    deg = raw * (avg_deg / raw.mean())
    cap = max(float(n) ** 0.5, 20.0 * avg_deg)
    deg = np.minimum(deg, cap)
    deg = deg * (avg_deg / max(deg.mean(), 1e-9))   # re-center after cap
    return np.maximum(deg.astype(np.int64), 1)


def powerlaw_graph(num_nodes: int, avg_degree: float = 10.0,
                   alpha: float = 2.1, seed: int = 0) -> CSRGraph:
    """Configuration-model power-law graph (undirected, deduped, no loops)."""
    rng = np.random.default_rng(seed)
    # each edge consumes two stubs but contributes 2 to total degree after
    # symmetrization, so stub count per node ~ avg_degree gives mean ~avg_degree
    deg = _powerlaw_degrees(num_nodes, avg_degree, alpha, rng)
    stubs = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    rng.shuffle(stubs)
    if len(stubs) % 2:
        stubs = stubs[:-1]
    src, dst = stubs[0::2], stubs[1::2]
    return CSRGraph.from_edges(src, dst, num_nodes)


def sbm_graph(num_nodes: int, num_blocks: int = 16, avg_degree: float = 10.0,
              p_in: float = 0.8, alpha: float = 2.1, seed: int = 0
              ) -> tuple[CSRGraph, np.ndarray]:
    """Power-law degree-corrected stochastic block model.

    Returns ``(graph, block_labels)``.  Each stub connects within its block
    with probability ``p_in``, else to a uniform random stub — giving both the
    power-law degrees GNS exploits and community-correlated labels so node
    classification accuracy separates good from bad samplers.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_blocks, size=num_nodes)
    deg = _powerlaw_degrees(num_nodes, avg_degree, alpha, rng)
    stubs = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    rng.shuffle(stubs)
    if len(stubs) % 2:
        stubs = stubs[:-1]
    src, dst = stubs[0::2].copy(), stubs[1::2].copy()

    # Rewire cross-block pairs: with prob p_in, replace dst with a same-block
    # node (degree-biased within block via stub resampling).
    cross = labels[src] != labels[dst]
    rewire = cross & (rng.random(len(src)) < p_in)
    if rewire.any():
        # bucket stubs by block for biased within-block choice
        order = np.argsort(labels[stubs], kind="stable")
        sorted_stubs = stubs[order]
        block_of_sorted = labels[sorted_stubs]
        starts = np.searchsorted(block_of_sorted, np.arange(num_blocks))
        ends = np.searchsorted(block_of_sorted, np.arange(num_blocks), side="right")
        b = labels[src[rewire]]
        lo, hi = starts[b], ends[b]
        pick = lo + (rng.random(len(b)) * np.maximum(hi - lo, 1)).astype(np.int64)
        dst[rewire] = sorted_stubs[np.minimum(pick, len(sorted_stubs) - 1)]
    g = CSRGraph.from_edges(src, dst, num_nodes)
    return g, labels.astype(np.int32)


def node_features_from_labels(labels: np.ndarray, feat_dim: int,
                              noise: float = 1.0, seed: int = 0) -> np.ndarray:
    """Gaussian class-prototype features: x_i = proto[y_i] + noise*N(0,I).

    Weak per-node signal (noise ≥ 1) so a model must aggregate neighborhoods
    to classify well — i.e. sampler quality matters, as in the paper's tasks.
    """
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    protos = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    x = protos[labels] + noise * rng.normal(size=(len(labels), feat_dim)).astype(np.float32)
    return x.astype(np.float32)
