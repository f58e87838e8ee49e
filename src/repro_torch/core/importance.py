"""§3.4 — Importance sampling coefficients (eqs. 10–12).

Cached neighbors are biased samples; eq. (10) rescales aggregated features by
1/p so the sampled aggregation is an unbiased estimator of the full-neighbor
aggregation (eq. 5):

    p_u^C      = 1 - (1 - p_u)^{|C|}                       (eq. 11)
    p_u^(ℓ-1)  = p_u^C * k / min(k, N_C(v))                (eq. 12, as printed)
    h_N(v)     = f({ 1/p_u^(ℓ-1) * h_u })                  (eq. 10)

where p_u is the cache-sampling probability of u (eq. 6 / eq. 8), k the
fanout, and N_C(v) the number of v's neighbors present in the cache.

Faithfulness note: the paper's eq. (12) as printed
is not the Horvitz–Thompson inclusion probability of its own §3.3 sampling
procedure (take min(k, N_C(v)) cached neighbors *without replacement*), and
the paper itself is inconsistent between eq. (10) (weights 1/p) and
Algorithm 1 line 17 (weights p).  The HT inclusion probability of the
procedure is

    p_u^(ℓ-1) = p_u^C * min(k, N_C(v)) / N_C(v)            ("ht" mode)

which is what makes eq. (5)/(B.15) (unbiasedness) actually hold — and what
the convergence proof assumes.  We therefore default to ``mode="ht"`` and
property-test unbiasedness against a brute-force full aggregation
(tests/test_importance.py); ``mode="paper"`` implements eq. (12) literally
for fidelity comparisons.

Numerics: (1-p)^{|C|} underflows for hub nodes (p·|C| ≫ 1) so p^C saturates
at 1 — hubs are effectively always cached.  Computed via log1p/expm1; the
final inverse weight is clamped to keep variance bounded.
"""
from __future__ import annotations

import warnings

import numpy as np


def cache_hit_prob(p: np.ndarray, cache_size: int,
                   lam: float | None = None) -> np.ndarray:
    """eq. (11): probability a node lands in a |C|-sized cache drawn from p.

    With ``lam=None`` this is the paper's independence approximation
    (sampling w/o replacement treated as |C| independent draws); stable for
    tiny p via log1p.  With a calibrated ``lam`` (see
    :func:`solve_inclusion_lambda`) it is the successive-sampling inclusion
    probability 1 - exp(-λ·p), which removes the systematic hub bias of
    eq. (11) under without-replacement caches (measured at +10–15% E[Σw]
    inflation on power-law hubs — see tests/test_importance.py).
    """
    p = np.asarray(p, dtype=np.float64)
    if lam is not None and not (np.isfinite(lam) and lam > 0):
        # degenerate calibration (failed bracket, inf/nan, non-positive):
        # the λ path would return inclusion probabilities that don't sum to
        # |C| — fall back to the independence approximation instead.
        warnings.warn(
            f"cache_hit_prob: degenerate lam={lam!r}; falling back to the "
            "independence approximation (eq. 11)", RuntimeWarning)
        lam = None
    if lam is None:
        return -np.expm1(cache_size * np.log1p(-np.minimum(p, 1.0 - 1e-12)))
    return -np.expm1(-lam * p)


def solve_inclusion_lambda(probs: np.ndarray, cache_size: int,
                           tol: float = 1e-6,
                           max_iter: int = 200) -> float | None:
    """Calibrate λ so that Σ_i (1 - exp(-λ p_i)) = |C|.

    This is the classic inclusion-probability approximation for weighted
    sampling without replacement (successive sampling / Gumbel top-k): the
    paper's eq. (11) corresponds to λ = |C|, which *undershoots* when the
    distribution is skewed (hub probabilities saturate, so the remaining mass
    must be upweighted).  One-time cost per cache distribution — the GNS
    distribution is global and static (§3.6), so this is amortized like the
    distribution itself.

    Degenerate inputs return ``None`` with a warning, which callers
    (``cache_hit_prob(lam=None)``) treat as "use the independence
    approximation": a cache at least as large as the positive-probability
    support (every such node is included w.p. 1, λ* = ∞), an all-zero
    probability vector, or a bracket that fails to close numerically.
    """
    p = np.asarray(probs, dtype=np.float64)
    p = p[p > 0]
    if len(p) == 0:
        warnings.warn("solve_inclusion_lambda: all-zero probability vector; "
                      "falling back to the independence approximation",
                      RuntimeWarning)
        return None
    if cache_size >= len(p):
        warnings.warn(
            f"solve_inclusion_lambda: cache_size={cache_size} >= "
            f"{len(p)} positive-probability nodes — every node is cached "
            "(λ* = ∞); falling back to the independence approximation",
            RuntimeWarning)
        return None
    m = float(cache_size)

    def total(lam: float) -> float:
        return float(-np.expm1(-lam * p).sum())

    lo = float(cache_size)          # Σ(1-e^{-mp}) <= Σ m·p = m, so λ* >= m
    hi = lo
    for _ in range(64):
        if total(hi) >= m * (1 - 1e-12):
            break
        hi *= 2.0
    else:
        warnings.warn(
            "solve_inclusion_lambda: bisection failed to bracket "
            f"(cache_size={cache_size}, support={len(p)}); falling back to "
            "the independence approximation", RuntimeWarning)
        return None
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if total(mid) < m:
            lo = mid
        else:
            hi = mid
        if hi - lo <= tol * max(lo, 1.0):
            break
    return 0.5 * (lo + hi)


def importance_coefficients(neighbor_probs: np.ndarray,
                            cache_size: int,
                            fanout: int,
                            num_cached_neighbors: np.ndarray,
                            mode: str = "ht",
                            lam: float | None = None) -> np.ndarray:
    """Per-sampled-neighbor inclusion coefficient p_u^(ℓ-1).

    Args:
      neighbor_probs: p_u (cache distribution mass) for each sampled cached
        neighbor, shape (..., k).
      cache_size: |C|.
      fanout: k.
      num_cached_neighbors: N_C(v) of the destination node, broadcastable.
      mode: "ht" (Horvitz–Thompson, unbiased — default) or "paper" (eq. 12
        literal).

    Callers aggregate with weight 1/p_u^(ℓ-1) (eq. 10).  Clamped below so the
    inverse weight stays bounded.
    """
    p_c = cache_hit_prob(neighbor_probs, cache_size, lam=lam)
    ncv = np.maximum(np.asarray(num_cached_neighbors, dtype=np.float64), 1.0)
    k = float(fanout)
    if mode == "ht":
        coeff = p_c * np.minimum(k, ncv) / ncv
    elif mode == "paper":
        coeff = p_c * (k / np.minimum(k, ncv))
    else:
        raise ValueError(f"unknown importance mode: {mode}")
    return np.maximum(coeff, 1e-6)
