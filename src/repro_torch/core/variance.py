"""§3.5 probes: empirical estimator variance / gradient-MSE trends (port of
``repro.core.variance``).

Theorem 1 predicts the sampled-gradient MSE shrinks as cache fraction C̃ and
average degree C_d grow (the 1/(c·C̃·C_d·N₁N₂) terms).  We cannot re-derive
the constants, but we *can* verify the monotone trend empirically.  Host
numpy throughout, as the reference; the GNS sampler's store keeps its
device table on ``device``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sampler import (GNSSampler, NeighborSampler,
                                      SamplerConfig)
from repro_torch.featurestore import CacheConfig
from repro_torch.graph.csr import CSRGraph


def full_neighbor_mean(g: CSRGraph, h: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Exact one-hop mean aggregation (the eq. 5 target)."""
    out = np.zeros((len(nodes), h.shape[1]), dtype=np.float64)
    for r, v in enumerate(nodes):
        nb = g.neighbors(v)
        if len(nb):
            out[r] = h[nb].mean(axis=0)
    return out


def sampled_mean_once(sampler, nodes: np.ndarray, h: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """One-draw weighted estimate using a 1-layer sampler's block.

    For a 1-layer sampler the block's src array *is* the input-node array, so
    the block gather indexes directly into ``h[input_node_ids]``.
    """
    mb = sampler.sample(nodes, rng)
    blk = mb.device.blocks[-1]                 # output layer block
    feat = h[mb.input_node_ids]
    d = len(nodes)
    w = blk.nbr_w[:d][..., None]
    gathered = feat[blk.nbr_idx[:d]]
    return (w * gathered).sum(axis=1)


def estimator_mse(g: CSRGraph, h: np.ndarray, nodes: np.ndarray,
                  sampler_name: str, fanout: int, cache_fraction: float,
                  trials: int, seed: int = 0,
                  labels: np.ndarray | None = None, device=None) -> float:
    """Monte-Carlo MSE of the sampled one-hop mean vs the exact mean.  The
    GNS sampler builds its own store, its table on ``device`` (``None``:
    the GPU)."""
    rng = np.random.default_rng(seed)
    cfg = SamplerConfig(fanouts=(fanout,), batch_size=len(nodes),
                        cache=CacheConfig(fraction=cache_fraction, period=1))
    lbl = labels if labels is not None else np.zeros(g.num_nodes, np.int32)
    if sampler_name == "gns":
        s = GNSSampler(g, cfg, h.astype(np.float32), lbl, device=device)
        s.start_epoch(0, rng)
    else:
        s = NeighborSampler(g, cfg, h.astype(np.float32), lbl)
        s.start_epoch(0, rng)
    target = full_neighbor_mean(g, h, nodes)
    errs = []
    for t in range(trials):
        if sampler_name == "gns" and t and t % 8 == 0:
            s.refresh_cache(rng, version=t)    # re-randomize the cache too
        est = sampled_mean_once(s, nodes, h, rng)
        errs.append(((est - target) ** 2).mean())
    return float(np.mean(errs))
