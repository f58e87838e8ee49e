"""Pluggable cache-admission policies for the feature store.

Every policy maps a graph (plus optional training set and observed access
feedback) to a score per node; the cache generation is drawn from the
normalized scores by Gumbel top-k (see ``store.sample_cache``).

Shipped policies:

* ``degree``           — eq. (6): p_i ∝ deg(i).
* ``random_walk``      — eqs. (7)–(9): L-step fanout-weighted walk mass from
  the training set; used when V_S is a small fraction of V.
* ``uniform``          — baseline.
* ``reverse_pagerank`` — weighted reverse PageRank over sampling-reachability
  (*Graph Neural Network Training with Data Tiering*, arXiv:2111.05894):
  importance flows backward along edges with the per-source visit probability
  min(fanout/deg, 1), restarted at the training set.
* ``adaptive``         — EMA of observed request frequencies (the full
  requested-id traffic — hits AND misses — fed back through ``observe``);
  converges onto the realized working set, degree prior for cold start.
  Feeding only misses starves the EMA of nodes once they become hits, so
  they decay, get evicted, miss again — oscillating churn.

Registering a new policy::

    @register_policy
    class MyPolicy(CachePolicy):
        name = "mine"
        def scores(self, graph, train_idx=None): ...
"""
from __future__ import annotations

import inspect
import threading
from typing import Dict, Optional, Sequence, Type

import numpy as np

from repro_torch.analysis import guarded_by


# ---------------------------------------------------------------------------
# probability constructions (pure functions)
# ---------------------------------------------------------------------------

def degree_cache_probs(g) -> np.ndarray:
    """eq. (6): p_i = deg(i) / Σ deg(k)."""
    deg = g.degrees.astype(np.float64)
    s = deg.sum()
    if s == 0:
        return np.full(g.num_nodes, 1.0 / g.num_nodes)
    return deg / s


def random_walk_cache_probs(g, train_idx: np.ndarray,
                            fanouts: Sequence[int]) -> np.ndarray:
    """eqs. (7)–(9): L-step fanout-weighted walk mass from the training set.

    P^ℓ = (D·A + I) P^{ℓ-1} with D = diag(fanout_ℓ / deg).  The product
    fanout/deg is exactly the probability that a specific neighbor is drawn by
    node-wise sampling with that layer's fanout, so P^L is the expected
    visitation mass of node-wise sampling rooted at the training set.
    """
    n = g.num_nodes
    p = np.zeros(n, dtype=np.float64)
    p[train_idx] = 1.0 / max(len(train_idx), 1)
    deg = np.maximum(g.degrees, 1).astype(np.float64)
    src = np.repeat(np.arange(n, dtype=np.int64), g.degrees)  # edge sources
    dst = g.indices.astype(np.int64)
    for fanout in fanouts:
        scale = np.minimum(fanout / deg, 1.0)                 # row weight of D·A
        contrib = p[src] * scale[src]
        nxt = p.copy()                                        # the +I term
        np.add.at(nxt, dst, contrib)
        p = nxt
        s = p.sum()
        if s > 0:
            p /= s
    return p


def reverse_pagerank_cache_probs(g, train_idx: Optional[np.ndarray],
                                 alpha: float = 0.85, iters: int = 20,
                                 fanout: int = 10) -> np.ndarray:
    """Weighted reverse PageRank over sampling-reachability (arXiv:2111.05894).

    Node u accumulates importance from every v with u ∈ N(v), weighted by the
    probability min(fanout/deg(v), 1) that node-wise sampling at v visits a
    specific neighbor — i.e. PageRank run on the *reverse* sampling graph —
    with restart mass on the training set (uniform on V if none given).
    """
    n = g.num_nodes
    r = np.zeros(n, dtype=np.float64)
    if train_idx is not None and len(train_idx):
        r[train_idx] = 1.0 / len(train_idx)
    else:
        r[:] = 1.0 / n
    deg = np.maximum(g.degrees, 1).astype(np.float64)
    scale = np.minimum(fanout / deg, 1.0)
    src = np.repeat(np.arange(n, dtype=np.int64), g.degrees)
    dst = g.indices.astype(np.int64)
    p = r.copy()
    for _ in range(iters):
        flow = np.zeros(n, dtype=np.float64)
        np.add.at(flow, dst, p[src] * scale[src])   # reverse edge u<-v flow
        p = (1.0 - alpha) * r + alpha * flow
        s = p.sum()
        if s > 0:
            p /= s
    return p


def uniform_cache_probs(g) -> np.ndarray:
    return np.full(g.num_nodes, 1.0 / g.num_nodes)


# ---------------------------------------------------------------------------
# policy objects + registry
# ---------------------------------------------------------------------------

class CachePolicy:
    """Scores nodes for cache admission; stateful policies learn from traffic."""

    name: str = "base"
    stateful: bool = False      # True -> scores change between refreshes

    def bind(self, graph, train_idx: Optional[np.ndarray] = None) -> None:
        """Attach to a graph (allocate per-node state).  Idempotent."""

    def observe(self, ids: np.ndarray) -> None:
        """Feed back the node ids requested from the cache this batch — the
        full traffic, hits and misses alike (no-op unless stateful)."""

    def scores(self, graph, train_idx: Optional[np.ndarray] = None) -> np.ndarray:
        raise NotImplementedError

    def probs(self, graph, train_idx: Optional[np.ndarray] = None) -> np.ndarray:
        s = np.asarray(self.scores(graph, train_idx), dtype=np.float64)
        s = np.maximum(s, 0.0)
        tot = s.sum()
        if tot <= 0:
            return np.full(graph.num_nodes, 1.0 / graph.num_nodes)
        return s / tot


POLICIES: Dict[str, Type[CachePolicy]] = {}


def register_policy(cls: Type[CachePolicy]) -> Type[CachePolicy]:
    POLICIES[cls.name] = cls
    return cls


def make_policy(name: str, **kwargs) -> CachePolicy:
    """Instantiate a registered policy, passing only the kwargs it accepts."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown cache policy: {name!r} "
                         f"(registered: {sorted(POLICIES)})") from None
    sig = inspect.signature(cls.__init__)
    kw = {k: v for k, v in kwargs.items() if k in sig.parameters}
    return cls(**kw)


@register_policy
class DegreePolicy(CachePolicy):
    name = "degree"

    def scores(self, graph, train_idx=None) -> np.ndarray:
        return degree_cache_probs(graph)


@register_policy
class UniformPolicy(CachePolicy):
    name = "uniform"

    def scores(self, graph, train_idx=None) -> np.ndarray:
        return uniform_cache_probs(graph)


@register_policy
class RandomWalkPolicy(CachePolicy):
    name = "random_walk"

    def __init__(self, walk_fanouts: Sequence[int] = (15, 10, 5)):
        self.walk_fanouts = tuple(walk_fanouts)

    def scores(self, graph, train_idx=None) -> np.ndarray:
        assert train_idx is not None, "random_walk policy needs train_idx"
        return random_walk_cache_probs(graph, train_idx, self.walk_fanouts)


@register_policy
class ReversePageRankPolicy(CachePolicy):
    name = "reverse_pagerank"

    def __init__(self, alpha: float = 0.85, iters: int = 20, fanout: int = 10):
        self.alpha, self.iters, self.fanout = alpha, iters, fanout

    def scores(self, graph, train_idx=None) -> np.ndarray:
        return reverse_pagerank_cache_probs(graph, train_idx, alpha=self.alpha,
                                            iters=self.iters, fanout=self.fanout)


@register_policy
@guarded_by("_lock", "_ema", "_prior")
class AdaptivePolicy(CachePolicy):
    """EMA of observed request traffic, degree prior for cold start.

    ``observe`` is called with every node id requested from the device cache
    — hits as well as misses (the store feeds the full batch traffic).  The
    per-node EMA decays by ``decay`` at every refresh, so the scores track
    the recent working set.  Observing only misses would starve cached nodes
    of feedback: their EMA decays to the prior, they get evicted, miss, get
    readmitted — churn that the regression test in tests/test_featurestore.py
    pins down.  With no observations yet the policy degenerates to the degree
    policy (prior mass ``prior_weight``), so the first generation matches the
    paper's eq. (6) cache.
    """

    name = "adaptive"
    stateful = True

    def __init__(self, decay: float = 0.8, prior_weight: float = 1.0):
        self.decay = decay
        self.prior_weight = prior_weight
        self._ema: Optional[np.ndarray] = None
        self._prior: Optional[np.ndarray] = None
        # observe() runs on the sampling thread while scores() runs on the
        # async-refresh build thread; numpy buffer ops release the GIL,
        # so guard the EMA read/decay/accumulate explicitly.
        self._lock = threading.Lock()

    def bind(self, graph, train_idx=None) -> None:
        with self._lock:
            if self._ema is None or len(self._ema) != graph.num_nodes:
                self._ema = np.zeros(graph.num_nodes, dtype=np.float64)
                self._prior = degree_cache_probs(graph)

    def observe(self, ids: np.ndarray) -> None:
        if len(ids) == 0:
            return
        with self._lock:
            # the not-yet-bound check belongs INSIDE the lock: bind() may be
            # concurrently installing the EMA buffer from the build thread
            if self._ema is None:
                return
            np.add.at(self._ema, np.asarray(ids, dtype=np.int64), 1.0)

    def scores(self, graph, train_idx=None) -> np.ndarray:
        self.bind(graph, train_idx)
        with self._lock:
            s = self._ema + self.prior_weight * self._prior
            self._ema *= self.decay      # decay once per refresh
        return s
