"""Multi-tier feature store with pluggable cache policies + async refresh
(port of ``repro.featurestore.store``).

Three storage tiers:

  tier 0 — **device cache table** (``Generation.table``): |C| feature rows
           as a tensor on the store's torch device, read by the fused
           cache-lookup kernel (``repro_torch.kernels.cache_lookup``).
  tier 1 — **staging buffer** (``Generation.staged``): the host mirror the
           device table was uploaded from; serves host-side reads of cached
           rows without touching the big feature array.
  tier 2 — **host features** (``self.features``): the full [V, F] array;
           every read is metered as streamed bytes (the paper's §2.2 step 2).

Cache admission is delegated to a pluggable :class:`~.policies.CachePolicy`
(degree / random_walk / reverse_pagerank / adaptive / uniform — see
``policies.py``); the generation is drawn by Gumbel top-k without
replacement, exactly as the reference does, so the same seed gives the same
membership, slots and staging rows.

**Double-buffered async refresh** (the paper's Table 6 staleness result makes
this accuracy-neutral): ``begin_refresh`` builds the *next* generation on a
background thread — policy scoring, Gumbel top-k draw, host gather into the
shadow staging buffer, device upload, and (for GNS) the induced cache
adjacency — while serving keeps reading the live generation.
``swap_if_ready`` atomically publishes the shadow between batches.  Readers
always snapshot ``store.generation`` once per batch, so a batch's cache slots
and the table they index can never come from different generations.

One device: the table is never sharded across cards here.  A
``CacheConfig.shards`` above 1 still pads the table and the locality
placement still permutes rows, exactly as the reference lays them out.
With ``build_device_adj`` each generation also carries its cached-neighbor
CSR over device-table rows (``Generation.device_adj``), uploaded with the
table, for the device sampling backend.  Streaming ingest is not ported
yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import guarded_by
from repro_torch.device import resolve_device
from repro_torch.featurestore.meter import TrafficMeter
from repro_torch.featurestore.placement import (PlacementMap, RoutingTable,
                                                home_shard,
                                                routing_table_from_state,
                                                solve_placement)
from repro_torch.featurestore.policies import CachePolicy, make_policy


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    fraction: float = 0.01          # |C| / |V|   (paper default 1%)
    period: int = 1                 # refresh every `period` epochs (Table 6 P)
    strategy: str = "auto"          # any registered policy name | auto
    train_frac_threshold: float = 0.5   # auto: degree if train_frac >= this
    walk_fanouts: Sequence[int] = (15, 10, 5)  # per-layer fanouts for eq. (7)
    async_refresh: bool = False     # build next generation on a background thread
    shards: int = 1                 # device-table row shards;
                                    # the table is padded so shards divide evenly
    placement: str = "contiguous"   # "contiguous" (reproducible blocks)
                                    # | "locality" (per-generation permutation
                                    # from observed per-DP-group traffic)
    refresh_timeout_s: Optional[float] = None
                                    # straggler bound for absorbing an
                                    # in-flight refresh (slow uploads):
                                    # None blocks as before; a float keeps
                                    # training on the old generation instead

    def size(self, num_nodes: int) -> int:
        """Device-table rows: |C| padded so `shards` rows-per-shard are equal."""
        rows = max(int(num_nodes * self.fraction), 1)
        rows += (-rows) % max(self.shards, 1)
        return rows


def resolve_strategy(cfg: CacheConfig, num_nodes: int,
                     train_idx: Optional[np.ndarray]) -> str:
    """'auto' -> degree for mostly-train graphs, random_walk for sparse V_S."""
    strategy = cfg.strategy
    if strategy == "auto":
        train_frac = 0.0 if train_idx is None else len(train_idx) / num_nodes
        strategy = "degree" if train_frac >= cfg.train_frac_threshold else "random_walk"
        if train_idx is None:
            strategy = "degree"
    return strategy


def cache_probs(g, cfg: CacheConfig,
                train_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """One-shot §3.2 probabilities through the policy registry."""
    strategy = resolve_strategy(cfg, g.num_nodes, train_idx)
    policy = make_policy(strategy, walk_fanouts=cfg.walk_fanouts)
    policy.bind(g, train_idx)
    return policy.probs(g, train_idx)


@dataclasses.dataclass
class CacheState:
    """One sampled cache generation (versioned for async refresh at pod scale).

    **Shard-aware slot layout**: the device table holds ``table_rows`` rows
    partitioned into ``n_shards`` equal blocks.  With
    ``placement=None`` (contiguous) a global cache slot
    ``s`` lives on shard ``s // rows_per_shard`` at local row
    ``s % rows_per_shard``; a locality-aware generation instead carries an
    explicit :class:`~repro_torch.featurestore.placement.PlacementMap`
    permutation.
    Samplers and the host-side tiers keep using *logical* slots; the device
    upload and anything handed to the device go through :meth:`device_rows`
    (identity when contiguous), and :meth:`shard_of` / :meth:`local_row`
    resolve the owning shard either way.
    """
    node_ids: np.ndarray        # int64 [|C|]  sorted
    probs: np.ndarray           # float64 [V]  the distribution it was drawn from
    in_cache: np.ndarray        # bool [V]
    slot_of: np.ndarray         # int32 [V]  position in node_ids or -1
    version: int = 0
    n_shards: int = 1           # row shards of the device table
    table_rows: int = 0         # padded device-table rows (0 = len(node_ids))
    placement: Optional[PlacementMap] = None
                                # slot -> (shard, local row) permutation;
                                # None = contiguous blocks (identity)

    @property
    def size(self) -> int:
        return len(self.node_ids)

    @property
    def rows_per_shard(self) -> int:
        rows = self.table_rows if self.table_rows else len(self.node_ids)
        return max(rows // max(self.n_shards, 1), 1)

    def device_rows(self, slots: np.ndarray) -> np.ndarray:
        """Logical slots -> device-table rows (negatives pass through).

        The device tier is laid out in *device-row* order: row
        ``shard * rows_per_shard + local_row``.  Contiguous generations are
        the identity; locality generations apply the placement permutation.
        Everything shipped to the device (``input_cache_slots``, the fused
        kernel's slot map) carries device rows, so the kernel's contiguous
        ``divmod`` stays valid whatever the placement.
        """
        slots = np.asarray(slots)
        if self.placement is None:
            return slots
        return self.placement.device_rows(slots)

    def shard_of(self, slots: np.ndarray) -> np.ndarray:
        """Shard index per global slot (negative slots stay negative)."""
        dev = self.device_rows(slots)
        return np.where(dev >= 0, dev // self.rows_per_shard, -1)

    def local_row(self, slots: np.ndarray) -> np.ndarray:
        """Row within the owning shard per global slot (-1 for misses)."""
        dev = self.device_rows(slots)
        return np.where(dev >= 0, dev % self.rows_per_shard, -1)


def sample_cache(g, cfg: CacheConfig, rng: np.random.Generator,
                 train_idx: Optional[np.ndarray] = None,
                 probs: Optional[np.ndarray] = None,
                 version: int = 0,
                 n_shards: Optional[int] = None,
                 table_rows: Optional[int] = None) -> CacheState:
    """Draw the cache without replacement according to the §3.2 distribution.

    ``n_shards`` / ``table_rows`` fix the shard layout of the device table
    the drawn ids will be uploaded into (defaults: the config's shard count
    and padded row count).  Fewer ids than rows is fine — the tail rows are
    zero-padded and no slot ever points at them.
    """
    if probs is None:
        probs = cache_probs(g, cfg, train_idx)
    if table_rows is None:
        table_rows = cfg.size(g.num_nodes)
    if n_shards is None:
        n_shards = max(cfg.shards, 1)
    assert table_rows % max(n_shards, 1) == 0, (
        f"table_rows={table_rows} must divide n_shards={n_shards} — pad via "
        f"CacheConfig(shards=...) / FeatureStore.padded_rows, otherwise "
        f"shard_of/local_row misroute the tail slots")
    size = min(table_rows, int((probs > 0).sum()))
    # Efficient weighted sampling w/o replacement: Gumbel top-k on log p.
    with np.errstate(divide="ignore"):
        logp = np.log(probs)
    gumbel = -np.log(-np.log(rng.random(g.num_nodes) + 1e-300) + 1e-300)
    keys = np.where(np.isfinite(logp), logp + gumbel, -np.inf)
    ids = np.sort(np.argpartition(keys, -size)[-size:].astype(np.int64))
    in_cache = np.zeros(g.num_nodes, dtype=bool)
    in_cache[ids] = True
    slot_of = np.full(g.num_nodes, -1, dtype=np.int32)
    slot_of[ids] = np.arange(size, dtype=np.int32)
    return CacheState(node_ids=ids, probs=probs, in_cache=in_cache,
                      slot_of=slot_of, version=version,
                      n_shards=n_shards, table_rows=table_rows)


@dataclasses.dataclass
class Generation:
    """One cache generation: membership + both storage tiers.

    ``state`` and ``table`` are immutable for the generation's whole
    lifetime (the device table is a fresh array per build), so a snapshot's
    slots always match its table.  ``staged`` aliases one half of the
    store's double buffer: when that half is recycled for a later build the
    store flips ``retired`` first, and staging reads fall back to the host
    tier — a stale handle can never serve another generation's rows.
    """
    state: CacheState
    table: object               # torch.Tensor [size, F] — device tier
    staged: np.ndarray          # f32 [size, F] host staging mirror
    staged_idx: int             # which double-buffer half `staged` is
    lam: Optional[float] = None  # calibrated inclusion λ (importance.py)
    cache_adj: object = None    # induced cached-neighbor CSR (GNS §3.3)
    device_adj: object = None   # repro_torch.sampling.DeviceCacheAdj — the
                                # same CSR over device-table rows, on the
                                # device, published with the table
    graph: object = None        # the CSRGraph this generation was built
                                # against (samplers adopt structure WITH
                                # the generation)
    retired: bool = False       # staging half recycled by a newer build

    @property
    def version(self) -> int:
        return self.state.version

    def retire(self) -> None:
        """Mark stale and drop the O(V)/O(E_C) host references so queued
        MiniBatches holding this generation pin only the device table and
        the small membership id list, not ~GBs of per-node state at paper
        scale.  The sampler adopts each new generation long before its
        predecessor's staging half is recycled, so nothing reads these
        fields from a retired generation (gather_rows falls back to the
        host tier).  ``device_adj`` is KEPT: like the table it lives on the
        device (no O(V) host memory), and a queued batch of this generation
        still draws from it."""
        self.retired = True
        self.cache_adj = None
        self.graph = None     # samplers adopted long ago; don't pin O(E)
        self.state.probs = None
        self.state.in_cache = None
        self.state.slot_of = None


@guarded_by("_lock", "_shadow", "_thread", "_refresh_err",
            writes_only=("_live", "swaps", "refreshes"))
class FeatureStore:
    """Facade over the three feature tiers + the cache refresh lifecycle.

    Concurrency contract (the reference's, which ``gnscheck`` checks
    there): the refresh thread, the serving worker, and the training loop
    coordinate through ``_lock``.  ``_shadow``/``_thread``/``_refresh_err``
    are read AND written under it; ``_live`` and the monotonic counters follow the
    publish/snapshot idiom — writes are locked so the reference swap and
    increments are atomic, while lock-free snapshot reads (the
    ``generation`` property, test assertions on ``swaps``) are the API.
    """

    def __init__(self, features: np.ndarray, graph, cfg: CacheConfig, *,
                 device=None,
                 policy: Optional[CachePolicy] = None,
                 train_idx: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.float32,
                 meter: Optional[TrafficMeter] = None,
                 importance_mode: Optional[str] = "ht",
                 build_adjacency: bool = False,
                 dp_group: int = 0,
                 seed: int = 0):
        """``device`` is where each generation's table lives (``None``: the
        GPU, raising without one); ``dtype`` is its element type (float32,
        or bfloat16 to halve its bytes)."""
        self.features = features
        self.graph = graph
        self.device = resolve_device(device)
        n_shards = max(cfg.shards, 1)
        if n_shards != cfg.shards:
            cfg = dataclasses.replace(cfg, shards=n_shards)
        self.n_shards = n_shards
        self.cfg = cfg
        self.train_idx = train_idx
        if policy is None:
            name = resolve_strategy(cfg, graph.num_nodes, train_idx)
            policy = make_policy(name, walk_fanouts=cfg.walk_fanouts)
        elif isinstance(policy, str):
            policy = make_policy(policy, walk_fanouts=cfg.walk_fanouts)
        self.policy = policy
        self.policy.bind(graph, train_idx)
        self.meter = meter if meter is not None else TrafficMeter()
        self.dtype = dtype
        self.importance_mode = importance_mode
        self.build_adjacency = build_adjacency
        self.build_device_adj = False   # also build the device-row CSR of
                                        # each generation (device sampler)
        self.size = cfg.size(graph.num_nodes)
        self.feat_dim = features.shape[1]
        self._row_bytes = self.feat_dim * 4
        self.dp_group = dp_group    # DP group this store's batches belong to
                                    # (assemble_input default; locality
                                    # histograms and home-shard metering)

        # double-buffered host staging (tier 1): live half + shadow half
        self._staging = [np.zeros((self.size, self.feat_dim), np.float32)
                         for _ in range(2)]
        self._staging_owner: list = [None, None]   # Generation using each half
        self._live: Optional[Generation] = None
        self._shadow: Optional[Generation] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._refresh_err: Optional[BaseException] = None
        self._static_probs: Optional[np.ndarray] = None
        self._lam_cache: Optional[tuple] = None
        self._rng = np.random.default_rng(seed)
        self.refreshes = 0
        self.swaps = 0
        self.record = True          # False: suspend meter + policy feedback
                                    # (evaluation must not skew training
                                    # metrics or the adaptive traffic EMA)
        self.serve_meter: Optional[TrafficMeter] = None
                                    # serving mode (record=False + a meter
                                    # here, via ``serving()``): tier/time
                                    # accounting lands on THIS meter while
                                    # policy/placement feedback stays live —
                                    # serving traffic steers the cache
                                    # without touching training metrics

    # ------------------------------------------------------------------
    # generation access (readers snapshot once per batch)
    # ------------------------------------------------------------------
    @property
    def generation(self) -> Optional[Generation]:
        """The live generation.  Snapshot it once and use only the snapshot:
        the (state, table) pair inside one Generation is immutable, so a
        reader can never see slots from one version and rows from another."""
        return self._live

    @property
    def state(self) -> Optional[CacheState]:
        gen = self._live
        return gen.state if gen is not None else None

    @property
    def version(self) -> int:
        gen = self._live
        return gen.version if gen is not None else -1

    @property
    def refreshing(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    def routing_table(self) -> Optional["RoutingTable"]:
        """Node -> owning-shard view of the LIVE generation (None pre-build).

        Derived from the live ``CacheState`` (whose ``slot_of`` is intact —
        only retired generations drop it), so a serving router can re-adopt
        it at every swap: the placement solver moves rows toward the DP
        group that requests them, and this table is how the router learns
        where they went.
        """
        gen = self._live
        if gen is None:
            return None
        return routing_table_from_state(gen.state, self.graph.num_nodes)

    # ------------------------------------------------------------------
    # accounting modes
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def serving(self, meter: TrafficMeter):
        """Serving-mode accounting scope (the GNSServer's sampling window).

        Inside the scope, ``assemble_input`` routes its tier/time/locality
        counters to ``meter`` — a serving-side :class:`TrafficMeter` view —
        instead of the training meter, while the adaptive policy's EMA and
        the placement demand histograms KEEP observing: serving traffic must
        steer cache admission and shard placement (the cache converges onto
        the inference hot set) without inflating training metrics.  Contrast
        ``record = False`` alone (evaluation), which suspends everything.

        Not safe to interleave with a concurrent ``fit``/``evaluate`` on the
        same store — one accounting mode at a time (the serving loop holds
        the scope only while it samples, on its single worker thread).
        """
        prev_record, prev_meter = self.record, self.serve_meter
        self.record, self.serve_meter = False, meter
        try:
            yield self
        finally:
            self.record, self.serve_meter = prev_record, prev_meter

    # ------------------------------------------------------------------
    # tier reads
    # ------------------------------------------------------------------
    def assemble_input(self, gen: Generation, ids_p: np.ndarray, n_in: int,
                       group: Optional[int] = None):
        """Resolve padded input ids against one generation.

        Returns ``(slots, streamed, num_cached, bytes_streamed,
        local_shard)``.  ``slots`` are **device rows** (the table is laid
        out in device-row order — identical to logical slots for contiguous
        generations); hits are served by the device table (tier 0, counted
        but not copied); misses are gathered from host features (tier 2)
        into the per-batch streamed array and fed back to the policy.

        ``local_shard`` is the requesting group's home shard when EVERY hit
        row of this batch lives on it (else None; always None when the
        table has one shard).
        """
        if group is None:
            group = self.dp_group
        state = gen.state
        slots = state.device_rows(state.slot_of[ids_p]).astype(np.int32)
        slots[n_in:] = -1
        valid = np.zeros(len(ids_p), dtype=bool)
        valid[:n_in] = True
        miss = (slots < 0) & valid
        hits = int(((slots >= 0) & valid).sum())
        t0 = time.perf_counter()
        streamed = np.zeros((len(ids_p), self.feat_dim), np.float32)
        miss_ids = ids_p[miss]
        if len(miss_ids):
            streamed[miss] = self.features[miss_ids]
        # locality: which shard serves each hit, vs the group's home shard
        home = home_shard(group, state.n_shards)
        hit_shards = slots[(slots >= 0) & valid] // state.rows_per_shard
        n_local = int((hit_shards == home).sum())
        all_local = state.n_shards > 1 and n_local == len(hit_shards)
        # accounting sink for this mode: the training meter, the serving
        # meter (``serving()`` scope), or nothing (evaluation)
        meter = self.meter if self.record else self.serve_meter
        if meter is not None:
            meter.t_slice += time.perf_counter() - t0
            dev = meter.tier("device")
            dev.hits += hits
            dev.misses += len(miss_ids)
            dev.bytes_read += hits * self._row_bytes
            host = meter.tier("host")
            host.hits += len(miss_ids)
            host.bytes_read += len(miss_ids) * self._row_bytes
            meter.lanes_local += n_local
            meter.lanes_remote += hits - n_local
            meter.bytes_cross_shard += (hits - n_local) * self._row_bytes
            if self.cfg.placement == "locality":
                # per-group demand histogram: the placement solver's input.
                # ALWAYS on the training meter — the solver reads exactly
                # one demand signal, and serving traffic must steer the
                # next generation's placement too.
                self.meter.observe_group(group, ids_p[:n_in],
                                         self.graph.num_nodes)
            # feed the FULL requested-id traffic (hits AND misses) to the
            # policy: a miss-only feed starves the EMA of nodes once they
            # become hits, so their scores decay until eviction and they
            # oscillate in and out of the cache (see AdaptivePolicy).
            self.policy.observe(ids_p[:n_in])
        return (slots, streamed, hits, len(miss_ids) * self._row_bytes,
                home if all_local else None)

    def gather_rows(self, ids: np.ndarray,
                    gen: Optional[Generation] = None,
                    record: Optional[bool] = None) -> np.ndarray:
        """Host-side row gather through the tier hierarchy.

        Rows present in the generation are served from the staging
        buffer (tier 1); the rest fall through to the host features (tier 2).
        This is the refresh path's row source (``_build`` seeds each new
        generation from the live generation's staging mirror, so rows kept
        across generations never touch the big feature array) and the
        public API for host-side reads.  ``record=None`` inherits the
        store's accounting flag.
        """
        if record is None:
            record = self.record
        ids = np.asarray(ids, dtype=np.int64)
        rows = np.empty((len(ids), self.feat_dim), np.float32)
        rest = np.ones(len(ids), dtype=bool)
        if gen is None:
            gen = self._live
        # capture the slot map before the retired check: retire() drops it,
        # and holding our own reference keeps the array alive mid-read
        sl_map = gen.state.slot_of if gen is not None else None
        if gen is not None and not gen.retired and sl_map is not None:
            # ids past the map are nodes merged in AFTER this generation was
            # drawn (streaming ingest): pure misses, served by the host tier
            sl = np.full(len(ids), -1, dtype=sl_map.dtype)
            known = ids < len(sl_map)
            sl[known] = sl_map[ids[known]]
            hit = sl >= 0
            rows[hit] = gen.staged[sl[hit]]
            if gen.retired:
                # build thread recycled this half mid-read (it flips the flag
                # BEFORE writing): discard and fall through to the host tier
                rest = np.ones(len(ids), dtype=bool)
            else:
                if record:
                    st = self.meter.tier("staging")
                    st.hits += int(hit.sum())
                    st.misses += int((~hit).sum())
                    st.bytes_read += int(hit.sum()) * self._row_bytes
                rest = ~hit
        n_rest = int(rest.sum())
        if n_rest:
            rows[rest] = self.features[ids[rest]]
            if record:
                host = self.meter.tier("host")
                host.hits += n_rest
                host.bytes_read += n_rest * self._row_bytes
        return rows

    # ------------------------------------------------------------------
    # refresh lifecycle
    # ------------------------------------------------------------------
    def _policy_probs(self) -> np.ndarray:
        if not self.policy.stateful:
            if self._static_probs is None:
                self._static_probs = self.policy.probs(self.graph, self.train_idx)
            return self._static_probs
        return self.policy.probs(self.graph, self.train_idx)

    def _solve_lambda(self, probs: np.ndarray) -> Optional[float]:
        if self.importance_mode != "ht":
            return None
        if self._lam_cache is not None and self._lam_cache[0] is probs:
            return self._lam_cache[1]
        from repro_torch.core.importance import solve_inclusion_lambda
        lam = solve_inclusion_lambda(probs, self.size)
        self._lam_cache = (probs, lam)
        return lam

    def _solve_placement(self, state: CacheState,
                         rng: np.random.Generator) -> Optional[PlacementMap]:
        """Locality placement for one generation (None = stay contiguous).

        Uses the meter's per-DP-group request histograms restricted to the
        drawn membership; until any traffic is observed the layout stays
        contiguous.  The reference's incremental re-solve serves streaming
        ingest, which is not ported.
        """
        if self.cfg.placement != "locality" or self.n_shards <= 1:
            return None
        traffic = self.meter.group_slot_traffic(state.node_ids,
                                                state.table_rows)
        if traffic is None:
            return None
        seed = int(rng.integers(2 ** 31))
        return solve_placement(traffic, self.n_shards, state.rows_per_shard,
                               group_ids=list(self.meter.group_ids()),
                               seed=seed)

    def _build(self, rng: np.random.Generator, version: int,
               staged_idx: int) -> Generation:
        """Build one full generation: score → draw → place → gather → upload."""
        t0 = time.perf_counter()
        g = self.graph      # ONE snapshot: everything this generation carries
                            # (membership, probs, adjacency, routing) must
                            # come from the same structure
        probs = self._policy_probs()
        state = sample_cache(g, self.cfg, rng,
                             train_idx=self.train_idx, probs=probs,
                             version=version,
                             n_shards=self.n_shards, table_rows=self.size)
        state.placement = self._solve_placement(state, rng)
        # recycle this staging half: retire its previous owner BEFORE writing
        # so stale snapshots fall back to the host tier instead of reading
        # another generation's rows (see gather_rows)
        prev = self._staging_owner[staged_idx]
        if prev is not None:
            prev.retire()
        buf = self._staging[staged_idx]
        n = state.size
        # seed the new generation through the tier hierarchy: rows that
        # survive from the live generation come out of its staging mirror
        # (tier 1, cheap sequential reads), only the delta touches the big
        # feature array — unmetered (bytes_cache_fill is the refresh metric)
        buf[:n] = self.gather_rows(state.node_ids, gen=self._live,
                                   record=False)
        if n < self.size:
            buf[n:] = 0.0
        tbl = self._upload(buf, state)
        lam = self._solve_lambda(probs)
        adj = (g.induced_cache_adjacency(state.in_cache)
               if self.build_adjacency else None)
        dev_adj = None
        if self.build_device_adj and adj is not None:
            # imported here: sampling.adjacency imports core, whose sampler
            # imports this module
            from repro_torch.sampling.adjacency import build_device_cache_adj
            dev_adj = build_device_cache_adj(state, adj, g.degrees, lam=lam,
                                             meter=self.meter,
                                             device=self.device)
        gen = Generation(state=state, table=tbl, staged=buf,
                         staged_idx=staged_idx, lam=lam, cache_adj=adj,
                         device_adj=dev_adj, graph=g)
        self._staging_owner[staged_idx] = gen
        self.meter.bytes_cache_fill += n * self._row_bytes
        self.meter.t_refresh += time.perf_counter() - t0
        with self._lock:      # build thread + owner thread both count
            self.refreshes += 1
        return gen

    def _upload(self, buf: np.ndarray, state: Optional[CacheState] = None):
        """Staging half -> device table (tier 0), metering the transfer.

        The staging tier keeps *logical* slot order; the device table is
        laid out in **device-row** order (``state.placement`` permutes on
        the way up — identity for contiguous generations).

        ``torch.from_numpy`` aliases the staging half, which a later build
        recycles, so the table is always a copy (``copy=True``; for a CUDA
        table the host-to-device copy itself).  The copy is synchronised
        before the generation is published, so recycling the staging buffer
        can never mutate this generation's device tier.
        """
        pm = state.placement if state is not None else None
        if pm is not None and not pm.is_identity:
            buf = buf[pm.slot_of_device_row]       # fresh permuted copy
        tbl = torch.from_numpy(buf).to(device=self.device, dtype=self.dtype,
                                       copy=True)
        if tbl.is_cuda:
            torch.cuda.current_stream(tbl.device).synchronize()
        self.meter.bytes_cache_upload += tbl.numel() * tbl.element_size()
        self.meter.uploads += 1
        return tbl

    def _free_staging_idx(self) -> int:
        live = self._live
        return 1 - live.staged_idx if live is not None else 0

    def refresh(self, rng: Optional[np.random.Generator] = None,
                version: int = 0) -> Generation:
        """Synchronous refresh: build and immediately publish as live."""
        if rng is None:
            rng = self._rng
        with self._lock:
            t = self._thread
            pending = (t is not None and t.is_alive()) \
                or self._shadow is not None
        if pending:
            # absorb any in-flight async build first — two concurrent builds
            # would interleave writes into the same staging half
            self.wait_refresh()
        gen = self._build(rng, version, self._free_staging_idx())
        with self._lock:
            self._live = gen
            self._shadow = None
            self.swaps += 1
        return gen

    def begin_refresh(self, rng: Optional[np.random.Generator] = None,
                      version: int = 0) -> bool:
        """Kick an async build of the next generation (shadow).  Returns False
        if a refresh is already in flight or awaiting swap."""
        child = None
        staged_idx = 0

        def _run():
            try:
                gen = self._build(child, version, staged_idx)
                with self._lock:
                    self._shadow = gen
            except BaseException as e:   # surfaced at the next swap point
                with self._lock:
                    self._refresh_err = e

        t = threading.Thread(target=_run, daemon=True,
                             name="featurestore-refresh")
        # one locked region from the pending-check through t.start(): a
        # check-then-start window would let two callers both see "idle" and
        # interleave builds into the same staging half, and a concurrent
        # wait_refresh must never see a created-but-unstarted thread
        with self._lock:
            cur = self._thread
            if (cur is not None and cur.is_alive()) \
                    or self._shadow is not None:
                return False
            # derive an independent child rng NOW (in the caller's thread,
            # and only on the path that actually starts a build, so a False
            # return never perturbs the caller's stream) so the caller's
            # stream is never mutated concurrently by the build thread
            seed = (rng if rng is not None else self._rng).integers(
                0, 2**63 - 1)
            child = np.random.default_rng(seed)
            staged_idx = self._free_staging_idx()
            self._thread = t
            t.start()
        return True

    def swap_if_ready(self) -> bool:
        """Atomically publish a completed shadow generation.  Called between
        train steps — never concurrently with a reader holding a snapshot."""
        with self._lock:
            # error take-and-clear inside the lock: a lock-free read could
            # race the build thread's error publish and drop it
            err = self._refresh_err
            self._refresh_err = None
            if err is None:
                if self._shadow is None:
                    return False
                self._live, self._shadow = self._shadow, None
                self.swaps += 1
                return True
        raise err

    def wait_refresh(self, timeout: Optional[float] = None) -> bool:
        """Block until an in-flight refresh finishes, then swap it in."""
        with self._lock:      # pairs with begin_refresh's publish-and-start
            t = self._thread
        if t is not None:
            t.join(timeout)
        return self.swap_if_ready()

    # ------------------------------------------------------------------
    # shape helpers (used by repro_torch.gns.describe)
    # ------------------------------------------------------------------
    @staticmethod
    def padded_rows(num_nodes: int, fraction: float, multiple: int = 1) -> int:
        """Device-table row count, padded so ``multiple`` shards divide
        evenly (shape-only callers; delegates to ``CacheConfig.size`` so the
        padding rule has one home)."""
        return CacheConfig(fraction=fraction, shards=multiple).size(num_nodes)
