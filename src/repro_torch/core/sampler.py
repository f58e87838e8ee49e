"""§3.3 — Minibatch samplers (port of ``repro.core.sampler``).

Host-side (the paper samples in CPU, §2.2) and fully vectorized numpy; the
same seeds give the same blocks as the reference, array for array.  They
emit :class:`repro_torch.core.minibatch.MiniBatch` objects with run-constant
padded shapes.

Implemented:

* :class:`NeighborSampler` — node-wise neighbor sampling (GraphSAGE/NS), the
  paper's primary baseline.
* :class:`GNSSampler`      — the paper's contribution: cache-prioritized
  sampling with importance correction; input layer samples *only* from the
  cache (§4.1 setup).
* :class:`LadiesSampler`   — layer-dependent importance sampling (LADIES),
  with the paper's observed isolated-node pathology measurable per batch.
* :class:`LazyGCNSampler`  — mega-batch recycling (LazyGCN): fresh NS sample
  every R iterations, recycled in between (recycle growth rate rho).

With ``SamplerConfig(backend="device")``, :func:`make_sampler` builds the
GNS sampler whose input layer is drawn on the device
(:class:`repro_torch.sampling.device_sampler.DeviceGNSSampler`).

Weight conventions (all carried in ``nbr_w`` so the forward is identical for
every sampler):

* NS:     w = 1/|valid lanes|                       (plain mean, unbiased)
* GNS:    cached lane  w = 1/(p_u^(ℓ) · deg(v)),    p from eq. (11)–(12)
          top-up lane  w = |N(v)\\C| / (t_v · deg(v))
          → E[Σ w·h] = full-neighborhood *mean* (property-tested)
* LADIES: w = row-normalized 1/q_u  (the LADIES P̃ row normalization)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.importance import importance_coefficients
from repro_torch.core.minibatch import (DeviceBatch, LayerBlock, MiniBatch,
                                        block_pad_sizes, make_block, pad_to)
from repro_torch.featurestore import CacheConfig, CacheState
from repro_torch.featurestore.store import FeatureStore, Generation
from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    fanouts: Sequence[int] = (5, 10, 15)   # input-layer first (paper: 15,10,5 top-down)
    batch_size: int = 1000
    # GNS
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    importance_mode: str = "ht"            # "ht" | "paper"  (see importance.py)
    backend: str = "host"                  # "host" | "device" — where the GNS
                                           # input layer draws
    # LADIES
    layer_size: int = 512                  # nodes sampled per layer
    lane_cap: int = 32                     # max edges kept per dst row (HT-subsampled)
    # LazyGCN
    recycle_period: int = 2                # R
    recycle_growth: float = 1.1            # rho

    @property
    def num_layers(self) -> int:
        return len(self.fanouts)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

class _Stamp:
    """O(1) membership/local-index lookup over node ids, reusable across calls."""

    def __init__(self, num_nodes: int):
        self._ver = np.zeros(num_nodes, dtype=np.int64)
        self._idx = np.zeros(num_nodes, dtype=np.int64)
        self._gen = 0

    def set(self, ids: np.ndarray):
        self._gen += 1
        self._ver[ids] = self._gen
        self._idx[ids] = np.arange(len(ids))

    def contains(self, ids: np.ndarray) -> np.ndarray:
        return self._ver[ids] == self._gen

    def index(self, ids: np.ndarray) -> np.ndarray:
        return self._idx[ids]


def _union_src(dst_ids: np.ndarray, nbrs: np.ndarray, mask: np.ndarray,
               stamp: _Stamp) -> tuple[np.ndarray, np.ndarray]:
    """src ids = dst ++ (unique new neighbors); return (src_ids, local nbr idx).

    Masked lanes map to index 0 (their weight is 0 so the gathered value is
    discarded by the aggregation).
    """
    stamp.set(dst_ids)
    flat = nbrs[mask]
    new = np.unique(flat[~stamp.contains(flat)]) if len(flat) else flat[:0]
    src_ids = np.concatenate([dst_ids, new.astype(dst_ids.dtype)])
    stamp.set(src_ids)
    idx = np.zeros(nbrs.shape, dtype=np.int64)
    idx[mask] = stamp.index(nbrs[mask])
    return src_ids, idx


def _assemble(blocks_topdown: list[LayerBlock], input_ids: np.ndarray,
              targets: np.ndarray, features: np.ndarray, labels: np.ndarray,
              pad_sizes: list[tuple[int, int]], batch_pad: int,
              store: Optional[FeatureStore] = None,
              gen: Optional[Generation] = None) -> MiniBatch:
    """Pad, split input features into cache hits vs streamed rows, count bytes."""
    blocks = list(reversed(blocks_topdown))          # input-first
    s0 = pad_sizes[0][1]
    n_in = len(input_ids)
    ids_p = pad_to(input_ids.astype(np.int64), s0)
    input_mask = np.zeros(s0, dtype=np.float32)
    input_mask[:n_in] = 1.0

    if store is not None and gen is not None:
        # tier-resolved lookup: device-cache hits + metered host-gather
        # misses; slots are DEVICE rows (placement-permuted)
        slots, streamed, num_cached, bytes_streamed, local_shard = \
            store.assemble_input(gen, ids_p, n_in)
    else:
        slots = np.full(s0, -1, dtype=np.int32)
        miss = (slots < 0) & (input_mask > 0)
        streamed = np.zeros((s0, features.shape[1]), dtype=np.float32)
        streamed[miss] = features[ids_p[miss]]       # the CPU "slice" step (§2.2 step 2)
        num_cached = 0
        bytes_streamed = int(miss.sum()) * features.shape[1] * 4
        local_shard = None

    lbl = pad_to(labels[targets].astype(np.int32), batch_pad)
    lmask = np.zeros(batch_pad, dtype=np.float32)
    lmask[:len(targets)] = 1.0

    in_blk = blocks[0]
    real_rows = in_blk.dst_mask > 0
    isolated = int((np.abs(in_blk.nbr_w[real_rows]).sum(axis=1) == 0).sum())

    dev = DeviceBatch(blocks=tuple(blocks), input_cache_slots=slots,
                      input_streamed=streamed, input_mask=input_mask,
                      labels=lbl, label_mask=lmask)
    return MiniBatch(device=dev, input_node_ids=ids_p, num_input=n_in,
                     num_cached=num_cached, bytes_streamed=bytes_streamed,
                     num_isolated=isolated, cache_gen=gen,
                     local_shard=local_shard)


# ---------------------------------------------------------------------------
# Node-wise neighbor sampling (NS — GraphSAGE baseline)
# ---------------------------------------------------------------------------

class NeighborSampler:
    """Paper baseline: uniform node-wise neighbor sampling, mean weights."""

    name = "ns"

    def __init__(self, graph: CSRGraph, cfg: SamplerConfig,
                 features: np.ndarray, labels: np.ndarray):
        self.g, self.cfg = graph, cfg
        self.features, self.labels = features, labels
        self.pad_sizes = block_pad_sizes(cfg.batch_size, cfg.fanouts)
        self._stamp = _Stamp(graph.num_nodes)

    def start_epoch(self, epoch: int, rng: np.random.Generator):
        pass  # stateless across epochs

    def sample(self, targets: np.ndarray, rng: np.random.Generator) -> MiniBatch:
        cfg = self.cfg
        ids = np.asarray(targets, dtype=np.int64)
        blocks: list[LayerBlock] = []
        for li in range(cfg.num_layers - 1, -1, -1):      # output -> input
            k = cfg.fanouts[li]
            nbrs, mask = self.g.sample_neighbors(ids, k, rng)
            src_ids, idx = _union_src(ids, nbrs, mask, self._stamp)
            cnt = np.maximum(mask.sum(axis=1, keepdims=True), 1)
            w = np.where(mask, 1.0 / cnt, 0.0)
            pad_dst, pad_src = self.pad_sizes[li]
            blocks.append(make_block(idx, w, pad_dst, pad_src))
            ids = src_ids
        return _assemble(blocks, ids, targets, self.features, self.labels,
                         self.pad_sizes, cfg.batch_size)


# ---------------------------------------------------------------------------
# GNS — the paper's contribution
# ---------------------------------------------------------------------------

class GNSSampler:
    """Cache-prioritized neighbor sampling with importance correction (§3).

    The cache lifecycle is delegated to a :class:`FeatureStore`: the store
    owns the versioned generations (membership + staging + device table +
    induced cached-neighbor subgraph), ``start_epoch`` triggers a refresh
    every ``cache.period`` epochs (paper Table 6), and with
    ``cache.async_refresh`` the next generation is built on a background
    thread while sampling continues against the live one — the sampler adopts
    the new generation at the next swap point (``adopt_generation``).
    """

    name = "gns"

    def __init__(self, graph: CSRGraph, cfg: SamplerConfig,
                 features: np.ndarray, labels: np.ndarray,
                 train_idx: Optional[np.ndarray] = None,
                 store: Optional[FeatureStore] = None, device=None):
        """Without ``store`` the sampler builds its own, with its table on
        ``device`` (``None``: the GPU, raising without one)."""
        self.g, self.cfg = graph, cfg
        self.features, self.labels = features, labels
        self.train_idx = train_idx
        self.pad_sizes = block_pad_sizes(cfg.batch_size, cfg.fanouts)
        self._stamp = _Stamp(graph.num_nodes)
        # calibrated inclusion rate for eq. (11) under w/o-replacement caches
        # rides on each generation (store._solve_lambda); "paper" mode uses
        # the raw eq. (11) approximation.
        self.store = store if store is not None else FeatureStore(
            features, graph, cfg.cache, device=device, train_idx=train_idx,
            importance_mode=cfg.importance_mode, build_adjacency=True)
        self.store.build_adjacency = True    # §3.3 induced subgraph per refresh
        self._gen: Optional[Generation] = None
        self._epoch = -1

    # -- cache lifecycle ---------------------------------------------------
    @property
    def cache(self) -> Optional[CacheState]:
        return self._gen.state if self._gen is not None else None

    @property
    def cache_adj(self):
        return self._gen.cache_adj if self._gen is not None else None

    @property
    def _lam(self) -> Optional[float]:
        return self._gen.lam if self._gen is not None else None

    def refresh_cache(self, rng: np.random.Generator, version: int = 0):
        """Synchronous refresh + immediate adoption (seed-compatible API)."""
        self.store.refresh(rng, version=version)
        self.adopt_generation()

    def adopt_generation(self) -> bool:
        """Start sampling against the store's live generation (cheap: the
        expensive scoring/gather/adjacency work happened at build time).

        Swap-race contract: adoption only moves FORWARD — every batch
        sampled before this call keeps the generation object it was
        assembled against (``MiniBatch.cache_gen``), whose state/table pair
        is immutable for the generation's lifetime, so a batch sampled
        against generation *g* can never resolve slots against *g+1*'s
        table.
        """
        gen = self.store.generation
        if gen is None or gen is self._gen:
            return False
        assert self._gen is None or gen.version >= self._gen.version, (
            "generation adoption must be monotonic",
            gen.version, self._gen.version)
        self._gen = gen
        # streaming ingest: structure rides the swap.  A generation built
        # after a delta merge carries the post-merge graph (Generation.graph);
        # adopting it here — and only here — means every batch sampled before
        # this call used the pre-merge CSR end to end, and every batch after
        # sees the merged one, with the grown feature/label tiers adopted in
        # the same step.
        g = getattr(gen, "graph", None)
        if g is not None and g is not self.g:
            if g.num_nodes != self.g.num_nodes:
                self._stamp = _Stamp(g.num_nodes)
            self.g = g
            self.features = self.store.features
            if self.store.labels is not None:
                self.labels = self.store.labels
        return True

    def ensure_cache(self, rng: Optional[np.random.Generator] = None):
        if self._gen is None:
            self.refresh_cache(rng or np.random.default_rng(0), version=0)

    def start_epoch(self, epoch: int, rng: np.random.Generator):
        due = self._gen is None or epoch % self.cfg.cache.period == 0
        if due and (epoch != self._epoch or self._gen is None):
            if self.cfg.cache.async_refresh and self._gen is not None:
                # bounded staleness: if the previous refresh is still in
                # flight when the next one comes due, absorb it first — but
                # only up to ``refresh_timeout_s``: a straggling build (e.g.
                # a slow upload) must not stall the epoch, so on timeout
                # we keep consuming the old generation (paper Table 6:
                # stale caches are accuracy-neutral) and retry the absorb at
                # the next due point.
                if self.store.refreshing or self.store.swap_if_ready():
                    self.store.wait_refresh(
                        timeout=self.cfg.cache.refresh_timeout_s)
                    self.adopt_generation()
                if not self.store.refreshing:
                    self.store.begin_refresh(rng, version=epoch)
            else:
                self.refresh_cache(rng, version=epoch)
        self._epoch = epoch
        self.adopt_generation()

    # -- sampling ------------------------------------------------------------
    def _sample_layer(self, ids: np.ndarray, k: int, rng: np.random.Generator,
                      allow_topup: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (nbrs, mask, weights) of shape (n, k) / weights f64."""
        g, cache = self.g, self.cache
        deg = (g.indptr[ids + 1] - g.indptr[ids]).astype(np.float64)
        n_c = (self.cache_adj.indptr[ids + 1] - self.cache_adj.indptr[ids]).astype(np.float64)

        # 1) cached neighbors first (from the induced subgraph S)
        c_nbrs, c_mask = self.cache_adj.sample_neighbors(ids, k, rng)
        coeff = importance_coefficients(
            cache.probs[c_nbrs], cache.size, k, n_c[:, None],
            mode=self.cfg.importance_mode, lam=self._lam)
        w_uncond = 1.0 / (coeff * np.maximum(deg, 1.0)[:, None])

        if not allow_topup:
            # input layer: cache-only -> the cache draw is the only source of
            # randomness covering the neighborhood; use the unconditional
            # eq. (11)/(12) inclusion weights.
            return c_nbrs, c_mask, np.where(c_mask, w_uncond, 0.0)

        # Upper layers (§3.3 top-up).  Weighting must avoid double counting
        # (the paper leaves top-up weights unspecified — see importance.py):
        #  * rows with N_C(v) < k take ALL cached neighbors and top up; given
        #    the realized cache this is exact coverage of N_C plus uniform
        #    coverage of N\C -> conditional HT weights, no p^C factor:
        #       cached lane w = 1/deg,  top-up lane w = (deg-N_C)/(t_v·deg)
        #  * rows with N_C(v) >= k never see non-cached neighbors, so the
        #    cache randomness must be integrated over -> unconditional
        #    eq. (11)/(12) weights as at the input layer.
        cond_rows = (n_c < k)[:, None]
        w_cond = 1.0 / np.maximum(deg, 1.0)[:, None]
        w = np.where(c_mask, np.where(cond_rows, w_cond, w_uncond), 0.0)

        # 2) top-up lanes from non-cached neighbors
        need = k - c_mask.sum(axis=1)
        rows = np.where((need > 0) & (deg - n_c > 0))[0]
        if len(rows):
            t_nbrs, t_mask = g.sample_neighbors(ids[rows], k, rng)
            t_mask &= ~cache.in_cache[t_nbrs]            # rejection: non-cached only
            # keep at most `need` lanes per row
            lane_rank = np.cumsum(t_mask, axis=1)
            t_mask &= lane_rank <= need[rows, None]
            t_act = t_mask.sum(axis=1)
            non_c = (deg - n_c)[rows]
            tw = np.where(
                t_mask,
                (non_c / (np.maximum(t_act, 1) * np.maximum(deg[rows], 1.0)))[:, None],
                0.0)
            # pack top-up lanes into the free lanes after the cached ones
            free = ~c_mask[rows]
            free_rank = np.cumsum(free, axis=1)
            take = np.zeros_like(free)
            # map j-th valid top-up lane -> j-th free lane (vectorized pack)
            t_rank = np.cumsum(t_mask, axis=1)
            for j in range(1, k + 1):
                src_lane = (t_mask & (t_rank == j))
                dst_lane = (free & (free_rank == j))
                has = src_lane.any(axis=1) & dst_lane.any(axis=1)
                if not has.any():
                    break
                si = src_lane[has].argmax(axis=1)
                di = dst_lane[has].argmax(axis=1)
                rsel = rows[has]
                c_nbrs[rsel, di] = t_nbrs[has, si]
                c_mask[rsel, di] = True
                w[rsel, di] = tw[has, si]
            del take
        return c_nbrs, c_mask, w

    def sample(self, targets: np.ndarray, rng: np.random.Generator) -> MiniBatch:
        assert self.cache is not None, "call start_epoch/refresh_cache first"
        cfg = self.cfg
        ids = np.asarray(targets, dtype=np.int64)
        blocks: list[LayerBlock] = []
        for li in range(cfg.num_layers - 1, -1, -1):
            k = cfg.fanouts[li]
            allow_topup = li != 0        # input layer: cache only (§4.1)
            nbrs, mask, w = self._sample_layer(ids, k, rng, allow_topup)
            src_ids, idx = _union_src(ids, nbrs, mask, self._stamp)
            pad_dst, pad_src = self.pad_sizes[li]
            blocks.append(make_block(idx, np.where(mask, w, 0.0), pad_dst, pad_src))
            ids = src_ids
        return _assemble(blocks, ids, targets, self.features, self.labels,
                         self.pad_sizes, cfg.batch_size,
                         store=self.store, gen=self._gen)


# ---------------------------------------------------------------------------
# LADIES — layer-dependent importance sampling baseline
# ---------------------------------------------------------------------------

class LadiesSampler:
    """LADIES [Zou et al. '19], as benchmarked by the paper.

    q_u ∝ Σ_{v ∈ B_ℓ} Â²_{v,u} with Â row-normalized; samples ``layer_size``
    distinct nodes per layer, keeps edges between consecutive layers with
    1/(s·q_u) importance weights, row-renormalized (the LADIES P̃).  Rows with
    no sampled neighbor are the *isolated nodes* of paper Table 5.
    """

    name = "ladies"

    def __init__(self, graph: CSRGraph, cfg: SamplerConfig,
                 features: np.ndarray, labels: np.ndarray):
        self.g, self.cfg = graph, cfg
        self.features, self.labels = features, labels
        self._stamp = _Stamp(graph.num_nodes)
        self._inv_deg = 1.0 / np.maximum(graph.degrees, 1).astype(np.float64)
        b, s, L = cfg.batch_size, cfg.layer_size, cfg.num_layers
        # src chain: S_ℓ = D_ℓ + layer_size (input-first list)
        self.pad_sizes = [(b + (L - 1 - li) * s, b + (L - li) * s)
                          for li in range(L)]

    def start_epoch(self, epoch: int, rng: np.random.Generator):
        pass

    def _layer_probs(self, cur: np.ndarray) -> np.ndarray:
        """q ∝ Σ_{v∈cur} Â²_{v,·} — touched entries only."""
        g = self.g
        starts, ends = g.indptr[cur], g.indptr[cur + 1]
        lens = ends - starts
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        flat_src = np.repeat(np.arange(len(cur)), lens)
        flat_idx = np.concatenate([g.indices[s:e] for s, e in zip(starts, ends)])
        contrib = (self._inv_deg[cur[flat_src]]) ** 2
        cand, inv = np.unique(flat_idx, return_inverse=True)
        q = np.zeros(len(cand), dtype=np.float64)
        np.add.at(q, inv, contrib)
        return cand, q / q.sum()

    def sample(self, targets: np.ndarray, rng: np.random.Generator) -> MiniBatch:
        cfg = self.cfg
        ids = np.asarray(targets, dtype=np.int64)
        blocks: list[LayerBlock] = []
        K = cfg.lane_cap
        for li in range(cfg.num_layers - 1, -1, -1):
            cand, q = self._layer_probs(ids)
            s = min(cfg.layer_size, len(cand))
            if s > 0:
                gumbel = -np.log(-np.log(rng.random(len(cand)) + 1e-300) + 1e-300)
                keys = np.log(q + 1e-300) + gumbel
                picked = cand[np.argpartition(keys, -s)[-s:]]
            else:
                picked = cand
            self._stamp.set(picked)
            # node-id -> q lookup for weight computation
            qfull = np.zeros(self.g.num_nodes, dtype=np.float64)
            qfull[cand] = q
            # lanes: for each dst, neighbors ∩ picked, HT-subsampled to K
            nbrs = np.zeros((len(ids), K), dtype=np.int64)
            mask = np.zeros((len(ids), K), dtype=bool)
            w = np.zeros((len(ids), K), dtype=np.float64)
            starts, ends = self.g.indptr[ids], self.g.indptr[ids + 1]
            for r, (a, b) in enumerate(zip(starts, ends)):   # per-dst ragged; ids are small
                nb = self.g.indices[a:b]
                hit = nb[self._stamp.contains(nb)]
                if len(hit) == 0:
                    continue
                if len(hit) > K:
                    hit = rng.choice(hit, size=K, replace=False)
                    corr = 1.0   # row renorm below absorbs subsample correction
                else:
                    corr = 1.0
                m = len(hit)
                nbrs[r, :m] = hit
                mask[r, :m] = True
                w[r, :m] = corr / np.maximum(qfull[hit], 1e-12)
            rs = w.sum(axis=1, keepdims=True)
            w = np.where(mask, w / np.maximum(rs, 1e-12), 0.0)   # LADIES row norm
            src_ids, idx = _union_src(ids, nbrs, mask, self._stamp)
            pad_dst, pad_src = self.pad_sizes[li]
            blocks.append(make_block(idx, w, pad_dst, pad_src))
            ids = src_ids
        return _assemble(blocks, ids, targets, self.features, self.labels,
                         self.pad_sizes, cfg.batch_size)


# ---------------------------------------------------------------------------
# LazyGCN — mega-batch recycling baseline
# ---------------------------------------------------------------------------

class LazyGCNSampler:
    """LazyGCN [Ramezani et al. '20]: fresh NS sample every R iterations,
    recycled (identical computation graph) in between; recycle count grows by
    rho per period.  Captures the reuse/overfit tradeoff the paper measures
    (Fig. 4); the rho-growing megabatch is modeled by growing the recycle
    count (static shapes stay fixed), as the reference does.
    """

    name = "lazygcn"

    def __init__(self, graph: CSRGraph, cfg: SamplerConfig,
                 features: np.ndarray, labels: np.ndarray):
        self.inner = NeighborSampler(graph, cfg, features, labels)
        self.cfg = cfg
        self._cached: Optional[MiniBatch] = None
        self._uses_left = 0
        self._period = 0

    @property
    def pad_sizes(self):
        return self.inner.pad_sizes

    def start_epoch(self, epoch: int, rng: np.random.Generator):
        self._cached, self._uses_left = None, 0

    def sample(self, targets: np.ndarray, rng: np.random.Generator) -> MiniBatch:
        if self._uses_left > 0 and self._cached is not None:
            self._uses_left -= 1
            mb = self._cached
            # recycled batch: zero fresh feature traffic (it shares the
            # fresh batch's host arrays, so GNSEngine reuses their device copy)
            return dataclasses.replace(mb, bytes_streamed=0, num_input=mb.num_input)
        mb = self.inner.sample(targets, rng)
        r = max(int(round(self.cfg.recycle_period *
                          (self.cfg.recycle_growth ** self._period))), 1)
        self._period += 1
        self._cached, self._uses_left = mb, r - 1
        return mb


SAMPLERS = {
    "ns": NeighborSampler,
    "gns": GNSSampler,
    "ladies": LadiesSampler,
    "lazygcn": LazyGCNSampler,
}


def make_sampler(name: str, graph: CSRGraph, cfg: SamplerConfig,
                 features: np.ndarray, labels: np.ndarray,
                 train_idx: Optional[np.ndarray] = None,
                 store: Optional[FeatureStore] = None, device=None):
    """The sampler ``name`` for ``cfg``.  A GNS sampler without ``store``
    builds its own on ``device`` (``None``: the GPU)."""
    if name == "gns":
        if getattr(cfg, "backend", "host") == "device":
            # imported here: the sampling package imports this module
            from repro_torch.sampling.device_sampler import DeviceGNSSampler
            return DeviceGNSSampler(graph, cfg, features, labels,
                                    train_idx=train_idx, store=store,
                                    device=device)
        return GNSSampler(graph, cfg, features, labels, train_idx=train_idx,
                          store=store, device=device)
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}; known: "
                         f"{sorted(SAMPLERS)}")
    return SAMPLERS[name](graph, cfg, features, labels)
