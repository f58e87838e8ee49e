"""The benchmark's datasets, made in every run on the device from the
configuration's ``data_seed``.

The graph is a power-law degree-corrected stochastic block model: the
generator the port ships in ``repro_torch.graph.generate`` (``sbm_graph``,
``_powerlaw_degrees``, ``CSRGraph.from_edges``), rewritten here in torch
so that it runs on the card in a few seconds at the published sizes (the
numpy original takes minutes there) and so that a later change to the
program cannot change the benchmark's data.  The steps and the arithmetic
are the original's; the draws come from a ``torch.Generator`` seeded with
``data_seed`` on the device, so the graph is another sample of the same
model, the same in every run on the same card and torch.  Unlike
``repro_torch.graph.datasets`` it does not cap the classes at 32, so a
configuration's published class count stands.  The features are class
prototypes plus noise, ``x_i = proto[y_i] + noise * N(0, I)``, drawn in
one call; both end on the host, where the program keeps them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Dataset:
    """What the benchmark hands to the program and to its reference."""
    indptr: np.ndarray       # int64 [V + 1]
    indices: np.ndarray      # int32 [E], each row's neighbours ascending
    features: np.ndarray     # float32 [V, F]
    labels: np.ndarray       # int32 [V]
    train_idx: np.ndarray    # int64, ascending
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1


# ---------------------------------------------------------------------------
# the frozen generator
# ---------------------------------------------------------------------------

def powerlaw_degrees(n: int, avg_deg: float, alpha: float,
                     gen: torch.Generator) -> torch.Tensor:
    """Zipf(alpha) degrees scaled to ``avg_deg``, hubs capped at
    max(sqrt(n), 20 * avg_deg), re-centred after the cap, at least 1
    (int64, on the generator's device)."""
    u = torch.rand(n, generator=gen, device=gen.device, dtype=torch.float64)
    raw = u.clamp_(min=2.0 ** -53) ** (-1.0 / (alpha - 1.0))
    deg = raw * (avg_deg / raw.mean())
    cap = max(float(n) ** 0.5, 20.0 * avg_deg)
    deg = deg.clamp_(max=cap)
    deg = deg * (avg_deg / max(float(deg.mean()), 1e-9))
    return deg.long().clamp_(min=1)


def csr_from_edges(src: torch.Tensor, dst: torch.Tensor, n: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Undirected CSR of an edge list: both directions, no self loops, no
    duplicate edges, each row's neighbours ascending.  Host arrays."""
    src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])
    del src, dst, keep
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    indptr[1:] = torch.cumsum(torch.bincount(key // n, minlength=n), 0)
    return indptr.cpu().numpy(), (key % n).to(torch.int32).cpu().numpy()


def sbm_graph(n: int, num_blocks: int, avg_degree: float, p_in: float,
              alpha: float, seed: int, device
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(indptr, indices, labels)`` of a power-law degree-corrected SBM:
    each stub pairs at random, and a pair that crosses blocks is rewired
    with probability ``p_in`` to a stub of the source's block."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = gen.device
    labels = torch.randint(0, num_blocks, (n,), generator=gen, device=dev)
    deg = powerlaw_degrees(n, avg_degree, alpha, gen)
    stubs = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    stubs = stubs[torch.randperm(len(stubs), generator=gen, device=dev)]
    if len(stubs) % 2:
        stubs = stubs[:-1]
    src, dst = stubs[0::2].clone(), stubs[1::2].clone()
    rewire = (labels[src] != labels[dst]) & (
        torch.rand(len(src), generator=gen, device=dev) < p_in)
    if bool(rewire.any()):
        sorted_stubs = stubs[torch.argsort(labels[stubs], stable=True)]
        block_of_sorted = labels[sorted_stubs]
        blocks = torch.arange(num_blocks, device=dev)
        starts = torch.searchsorted(block_of_sorted, blocks)
        ends = torch.searchsorted(block_of_sorted, blocks, right=True)
        del block_of_sorted
        b = labels[src[rewire]]
        lo, hi = starts[b], ends[b]
        pick = lo + (torch.rand(len(b), generator=gen, device=dev,
                                dtype=torch.float64)
                     * (hi - lo).clamp(min=1)).long()
        dst[rewire] = sorted_stubs[pick.clamp(max=len(sorted_stubs) - 1)]
        del sorted_stubs
    del stubs
    indptr, indices = csr_from_edges(src, dst, n)
    return indptr, indices, labels.to(torch.int32).cpu().numpy()


def split(n: int, train_frac: float, val_frac: float, seed: int
          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Train, validation and test ids: one permutation from ``seed``."""
    perm = np.random.default_rng(seed).permutation(n)
    n_tr = int(n * train_frac)
    n_va = max(int(n * val_frac), 1)
    return (np.sort(perm[:n_tr]), np.sort(perm[n_tr:n_tr + n_va]),
            np.sort(perm[n_tr + n_va:]))


def make_features(labels: np.ndarray, classes: int, feat_dim: int,
                  noise: float, seed: int, device) -> np.ndarray:
    """Class prototypes plus noise, drawn on ``device`` from ``seed`` in
    one call and returned as a host float32 array."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn((classes + len(labels), feat_dim), generator=gen,
                       device=device)
    lab = torch.from_numpy(labels.astype(np.int64)).to(device)
    x = draw[:classes].index_select(0, lab).add_(draw[classes:], alpha=noise)
    del draw
    return x.cpu().numpy()


def load_dataset(name: str, data: dict, device) -> Dataset:
    """The configuration's whole dataset, made on ``device``."""
    seed = int(data["data_seed"])
    indptr, indices, labels = sbm_graph(
        int(data["nodes"]), int(data["num_classes"]),
        float(data["avg_degree"]), float(data["p_in"]), float(data["alpha"]),
        seed, device)
    feats = make_features(labels, int(data["num_classes"]),
                          int(data["feat_dim"]),
                          float(data["feature_noise"]), seed + 1, device)
    tr, va, te = split(len(labels), float(data["train_frac"]),
                       float(data["val_frac"]), seed + 2)
    return Dataset(indptr=indptr, indices=indices, features=feats,
                   labels=labels, train_idx=tr, val_idx=va, test_idx=te,
                   num_classes=int(data["num_classes"]))
