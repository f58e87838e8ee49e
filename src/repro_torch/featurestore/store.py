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

**Shard-aware generations** (``mesh`` + ``shard_axis``; one process per
mesh position, :mod:`repro_torch.launch.mesh`): the table is
row-partitioned into ``mesh.shape[shard_axis]`` contiguous blocks, and each
rank uploads only its own shard's rows (``bytes_cache_upload`` is 1/n of
the replicated upload).  Every rank builds the whole generation on the
host — the same draw, placement and version from the same seed — so the
ranks must agree on what they build and when they publish it:

* each rank samples only its own data-parallel group's batches, so its
  meter and policy see only that group's requests, where the reference's
  one store sees every group's.  At each refresh kickoff the ranks
  exchange the requests each group made since the last one (counts per
  node over the host group), and each rank replays the other groups' into
  its meter's histograms and its policy, as the reference's store saw
  them; the build then reads a snapshot of both, taken at the kickoff, so
  requests arriving during an async build cannot reach one rank's build
  and not another's;
* a finished async build is published only when it has finished on every
  rank (``swap_if_ready`` agrees by a MIN over the host group), and
  ``refreshing`` reads as true while any rank builds: every rank swaps at
  the same step, so no step combines shards of two generations.

* a build that failed on any rank is published on none: every rank
  drops its shadow and raises at the same ``swap_if_ready``;
* every rank builds from the leader's snapshot (global rank 0): at the
  kickoff the leader drains its streaming buffer, and its delta batch,
  its policy scores and its placement histograms are broadcast, so every
  rank merges the same deltas at the same generation and draws the same
  generation from the same inputs, even where its own threads booked the
  requests in another order (a serving fabric's concurrent workers).

Serving on a mesh samples every batch on every rank (``repro_torch.serve``),
so inside the ``serving()`` scope a request is already in every rank's
store and is not exchanged at the kickoff.

These agreements run on the thread that drives the store (the loader's,
a server's loop, a fabric's watchdog), on the host group, which no other
thread uses.  Without a mesh a
``CacheConfig.shards`` above 1 still pads the table and the locality
placement still permutes rows, exactly as the reference lays them out.
With ``build_device_adj`` each generation also carries its cached-neighbor
CSR over device-table rows (``Generation.device_adj``), uploaded with the
table, for the device sampling backend.

Streaming ingest (``attach_stream``): staged deltas of a
:class:`~repro_torch.stream.DeltaBuffer` are drained at the top of each
generation build and merged into the host tiers (``graph``, ``features``,
``labels``), so structure changes publish only through the atomic swap;
with ``placement="locality"`` the re-solve is incremental (rows whose
demand signature is unchanged keep their shard, ``rows_migrated`` counts
the rest).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import guarded_by
from repro_torch.device import resolve_device
from repro_torch.featurestore.meter import TrafficMeter
from repro_torch.featurestore.placement import (PlacementMap, RoutingTable,
                                                home_shard,
                                                routing_table_from_state,
                                                solve_placement,
                                                solve_placement_incremental)
from repro_torch.featurestore.policies import CachePolicy, make_policy
from repro_torch.launch.mesh import LEADER, broadcast_object


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
            writes_only=("_live", "swaps", "refreshes",
                         "merges_applied", "rows_migrated"))
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
                 mesh=None, shard_axis: Optional[str] = None,
                 seed: int = 0):
        """``device`` is where each generation's table lives (``None``: the
        GPU, raising without one); ``dtype`` is its element type (float32,
        or bfloat16 to halve its bytes).  ``mesh`` + ``shard_axis`` (default
        ``launch.mesh.cache_shard_axis``) turn on shard-aware generations:
        this rank's table is its shard's rows only."""
        self.features = features
        self.graph = graph
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and shard_axis is None:
            from repro_torch.launch.mesh import cache_shard_axis
            shard_axis = cache_shard_axis(mesh)
        self.shard_axis = shard_axis
        n_shards = (mesh.shape[shard_axis] if mesh is not None
                    else max(cfg.shards, 1))
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
        # --- streaming ingest (attach_stream) ----------------------------
        self.labels: Optional[np.ndarray] = None
                                    # host label array, grown alongside
                                    # `features` at merges (set by the engine;
                                    # plain ref-swap like `features`)
        self._stream = None         # DeltaBuffer | None — staged mutations
        self.stream_cfg = None      # StreamConfig | None
        self._merge_listeners: list = []
        self._placement_sig: Optional[dict] = None
                                    # previous solve's per-row demand
                                    # signature (incremental re-solve pins)
        self.merges_applied = 0
        self.rows_migrated = 0      # rows the incremental re-solve moved
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
        self.refresh_delay = 0.0    # test hook: artificial build latency (s)
        self.upload_delay = 0.0     # test hook: artificial upload latency (s)
        # on a mesh with several data-parallel groups: this rank's requests
        # per node since the last refresh kickoff (_merge_group_traffic)
        self._groups = 1
        self._replicated = False    # inside serving(): every rank samples
                                    # this batch, so nothing to exchange
        self._observed: Optional[np.ndarray] = None
        if mesh is not None:
            from repro_torch.kernels.ops import dp_group_count
            self._groups = dp_group_count(mesh, shard_axis)
            if self._groups > 1:
                self._observed = np.zeros(graph.num_nodes, np.int64)

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
        """An async build is running (on a mesh: on any rank)."""
        with self._lock:
            t = self._thread
        busy = t is not None and t.is_alive()
        return busy if self.mesh is None else not self._agree(not busy)

    def _agree(self, flag: bool) -> bool:
        """True on every rank iff ``flag`` is true on every rank (a MIN
        over the mesh's host group; every rank must call it)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.mesh.host_group)
        return bool(t.item())

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
    def serving(self, meter: TrafficMeter, group: Optional[int] = None):
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

        ``group`` stamps the data-parallel group the scope's requests book
        under (restored after); None leaves ``dp_group`` as it is.
        """
        prev = (self.record, self.serve_meter, self._replicated,
                self.dp_group)
        self.record, self.serve_meter, self._replicated = False, meter, True
        if group is not None:
            self.dp_group = group
        try:
            yield self
        finally:
            (self.record, self.serve_meter, self._replicated,
             self.dp_group) = prev

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
            if self._observed is not None and not self._replicated:
                self._observed += np.bincount(ids_p[:n_in],
                                              minlength=len(self._observed))
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
                         rng: np.random.Generator,
                         graph=None, demand: Optional[TrafficMeter] = None
                         ) -> Optional[PlacementMap]:
        """Locality placement for one generation (None = stay contiguous).

        Uses the meter's per-DP-group request histograms restricted to the
        drawn membership; until any traffic is observed (cold start, or a
        store whose batches never went through ``assemble_input``) the
        layout stays contiguous.

        Streaming stores (``attach_stream`` with ``incremental_placement``)
        re-solve **incrementally**: every row whose demand signature
        (hottest requesting group + degree) is unchanged since the previous
        solve keeps its shard via the solver's pin pass, so only rows the
        ingest actually touched migrate — bounded migration per merge, and
        the serving router's local fraction cannot collapse on a swap.

        ``demand`` is the meter whose histograms are read (default the
        training meter; a mesh store passes its kickoff snapshot).
        """
        if self.cfg.placement != "locality" or self.n_shards <= 1:
            return None
        if demand is None:
            demand = self.meter
        traffic = demand.group_slot_traffic(state.node_ids, state.table_rows)
        if traffic is None:
            return None
        if graph is None:
            graph = self.graph
        seed = int(rng.integers(2 ** 31))
        gids = list(demand.group_ids())
        node_ids = np.asarray(state.node_ids, dtype=np.int64)
        n = len(node_ids)
        # per-slot demand signature: hottest group (-1 when untouched) + degree
        total = traffic.sum(axis=0)
        hot = np.asarray(gids, dtype=np.int64)[np.argmax(traffic, axis=0)]
        hot = np.where(total > 0, hot, -1)[:n]
        deg = np.asarray(graph.degrees)[node_ids].astype(np.int64)
        prev = self._placement_sig
        scfg = self.stream_cfg
        pin = None
        if (prev is not None and len(prev["node_ids"])
                and scfg is not None and scfg.incremental_placement):
            pos = np.searchsorted(prev["node_ids"], node_ids)
            pos = np.clip(pos, 0, len(prev["node_ids"]) - 1)
            common = prev["node_ids"][pos] == node_ids
            same = common & (prev["hot"][pos] == hot) \
                & (prev["degree"][pos] == deg)
            pin = np.full(state.table_rows, -1, dtype=np.int64)
            pin[:n][same] = prev["shard"][pos[same]]
        if pin is not None and (pin >= 0).any():
            pm = solve_placement_incremental(
                traffic, self.n_shards, state.rows_per_shard,
                pin_shard=pin, group_ids=gids, seed=seed)
        else:
            pm = solve_placement(traffic, self.n_shards,
                                 state.rows_per_shard,
                                 group_ids=gids, seed=seed)
        new_shard = (np.asarray(pm.device_row_of_slot[:n], dtype=np.int64)
                     // state.rows_per_shard)
        if prev is not None and len(prev["node_ids"]):
            pos = np.searchsorted(prev["node_ids"], node_ids)
            pos = np.clip(pos, 0, len(prev["node_ids"]) - 1)
            common = prev["node_ids"][pos] == node_ids
            moved = int((new_shard[common]
                         != prev["shard"][pos[common]]).sum())
            if moved:
                with self._lock:
                    self.rows_migrated += moved
        order = np.argsort(node_ids, kind="stable")
        self._placement_sig = {"node_ids": node_ids[order],
                               "shard": new_shard[order],
                               "hot": hot[order],
                               "degree": deg[order]}
        return pm

    # ------------------------------------------------------------------
    # streaming ingest (repro_torch.stream)
    # ------------------------------------------------------------------
    def attach_stream(self, buffer, cfg=None) -> None:
        """Wire a :class:`repro_torch.stream.DeltaBuffer` into the refresh
        cycle.

        Producers stage mutations into ``buffer`` at any time; every
        subsequent generation build drains it FIRST (``_absorb_deltas``), so
        structure changes only ever publish through the atomic swap and
        in-flight batches pinned to older generations replay bitwise
        identically.  Set once, before serving starts.
        """
        from repro_torch.gns.config import StreamConfig
        self._stream = buffer
        self.stream_cfg = cfg if cfg is not None else StreamConfig()

    def add_merge_listener(self, cb) -> None:
        """``cb(store, batch)`` runs on the build thread right after a
        drained :class:`DeltaBatch` is folded into the host tiers (the
        engine uses this to keep its dataset view in sync)."""
        self._merge_listeners.append(cb)

    def pending_deltas(self) -> int:
        """Ops staged in the attached stream buffer (0 when none attached)."""
        buf = self._stream
        return buf.pending() if buf is not None else 0

    def stream_merge_due(self) -> bool:
        """True when enough deltas are staged to justify kicking a refresh
        (the fabric watchdog's drain trigger).  On a mesh it is the
        leader's answer on every rank (every rank must call it)."""
        cfg = self.stream_cfg
        due = (self._stream is not None and cfg is not None
               and self.pending_deltas() >= max(int(cfg.merge_min_pending),
                                                1))
        if self.mesh is not None:
            t = torch.tensor([int(due)], dtype=torch.int32)
            dist.broadcast(t, src=LEADER, group=self.mesh.host_group)
            due = bool(t.item())
        return due

    def _absorb_deltas(self, batch=None) -> bool:
        """Fold a drained :class:`DeltaBatch` into the host tiers (default:
        drain the stream buffer now).

        Runs at the top of ``_build`` — on a mesh at the kickoff, with the
        leader's batch — and generation builds are serialized
        (``begin_refresh`` single-flight + ``refresh`` absorbing in-flight
        builds), so this is the ONLY writer of ``graph``/``features``/
        ``labels``, and each is republished by a single reference swap
        (features strictly before graph: any reader that can see post-merge
        node ids must also see their feature rows).  Pre-merge readers keep
        their own refs via the pinned generation and never observe the swap.
        """
        if batch is None:
            buf = self._stream
            if buf is None or buf.pending() == 0:
                return False
            batch = buf.drain()
            if batch is None:
                return False
        # imported here: keeps featurestore <-> stream from importing
        # cyclically
        from repro_torch.stream.merge import merge_delta_csr
        cfg = self.stream_cfg
        sym = cfg.symmetrize if cfg is not None else True
        new_graph = merge_delta_csr(self.graph, batch, symmetrize=sym)
        feats = self.features
        if batch.num_new_nodes:
            feats = np.concatenate(
                [np.asarray(self.features),
                 batch.node_feats.astype(np.float32)])
            if self.labels is not None:
                lbl = (batch.node_labels if batch.node_labels is not None
                       else np.zeros(batch.num_new_nodes, np.int64))
                self.labels = np.concatenate(
                    [self.labels, lbl.astype(self.labels.dtype)])
        self.features = feats           # features BEFORE graph (see above)
        self.graph = new_graph
        self.policy.bind(new_graph, self.train_idx)
        # structure changed: every cached score/λ is stale
        self._static_probs = None
        self._lam_cache = None
        self.meter.bytes_delta_upload += batch.payload_bytes
        with self._lock:
            self.merges_applied += 1
        for cb in list(self._merge_listeners):
            cb(self, batch)
        return True

    def _merge_group_traffic(self) -> None:
        """Replay the other data-parallel groups' requests since the last
        kickoff into this rank's meter and policy (module docstring).  One
        rank per group (its shard 0) contributes its counts; a request
        count is replayed as that many requests of the node, which is what
        the reference's store saw, up to order (every increment is 1)."""
        from repro_torch.kernels.ops import dp_group_index
        mesh, axis = self.mesh, self.shard_axis
        own = dp_group_index(mesh, axis)
        counts = torch.zeros((self._groups, len(self._observed)),
                             dtype=torch.int64)
        if mesh.index(axis) == 0:
            counts[own] = torch.from_numpy(self._observed)
        dist.all_reduce(counts, group=mesh.host_group)
        nodes = np.arange(len(self._observed), dtype=np.int64)
        for group, row in enumerate(counts.numpy()):
            if group == own or not row.any():
                continue
            ids = np.repeat(nodes, row)
            if self.cfg.placement == "locality":
                self.meter.observe_group(group, ids, self.graph.num_nodes)
            self.policy.observe(ids)
        self._observed[:] = 0

    def _kickoff(self):
        """On a mesh, at a refresh's start in the caller's thread: merge the
        groups' requests, merge the leader's staged deltas on every rank,
        then snapshot what the build reads — the policy's probabilities and
        the placement histograms — and take the leader's on every rank (the
        module docstring).  ``None`` without a mesh (the build drains and
        reads all of them live, as the reference's)."""
        if self.mesh is None:
            return None
        if self._observed is not None:
            self._merge_group_traffic()
        buf = self._stream
        lead = self.mesh.rank == LEADER
        batch = buf.drain() if lead and buf is not None else None
        clocks = ((buf.next_node, buf.next_seq) if lead and buf is not None
                  else None)
        batch, clocks = broadcast_object((batch, clocks),
                                         self.mesh.host_group)
        if batch is not None:
            self._absorb_deltas(batch)
        if clocks is not None and buf is not None:
            buf.follow(*clocks)
        # every rank scores (the adaptive policy decays its EMA as it
        # scores), then builds from the leader's scores and histograms
        probs = self._policy_probs()
        hist = {g: h.copy() for g, h in self.meter.group_hist.items()}
        probs, hist = broadcast_object((probs, hist), self.mesh.host_group)
        demand = TrafficMeter()
        demand.group_hist = hist
        return probs, demand

    def _build(self, rng: np.random.Generator, version: int,
               staged_idx: int, frozen=None) -> Generation:
        """Build one full generation: score → draw → place → gather →
        upload.  ``frozen`` is :meth:`_kickoff`'s snapshot, or None."""
        t0 = time.perf_counter()
        if frozen is None:                 # a mesh merged at the kickoff
            self._absorb_deltas()
        g = self.graph      # ONE snapshot: everything this generation carries
                            # (membership, probs, adjacency, routing) must
                            # come from the same structure
        probs, demand = frozen if frozen is not None \
            else (self._policy_probs(), None)
        state = sample_cache(g, self.cfg, rng,
                             train_idx=self.train_idx, probs=probs,
                             version=version,
                             n_shards=self.n_shards, table_rows=self.size)
        state.placement = self._solve_placement(state, rng, graph=g,
                                                demand=demand)
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
        if self.refresh_delay:
            time.sleep(self.refresh_delay)            # test hook
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

        On a mesh only this rank's shard goes up: the rows ``[m·rps,
        (m+1)·rps)`` of the device-row-ordered table.
        """
        pm = state.placement if state is not None else None
        if pm is not None and not pm.is_identity:
            buf = buf[pm.slot_of_device_row]       # fresh permuted copy
        if self.upload_delay:
            time.sleep(self.upload_delay)          # test hook: slow upload
        if self.mesh is not None:
            rps = self.size // self.n_shards
            lo = self.mesh.index(self.shard_axis) * rps
            buf = buf[lo:lo + rps]                 # a view; copied below
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
        if self.mesh is not None:                  # one answer on every rank
            pending = not self._agree(not pending)
        if pending:
            # absorb any in-flight async build first — two concurrent builds
            # would interleave writes into the same staging half
            self.wait_refresh()
        gen = self._build(rng, version, self._free_staging_idx(),
                          self._kickoff())
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
        frozen = None
        if self.mesh is not None:
            # start everywhere or nowhere, and merge the groups' requests
            # here, on the caller's thread, never on the build thread
            with self._lock:
                cur = self._thread
                idle = not ((cur is not None and cur.is_alive())
                            or self._shadow is not None)
            if not self._agree(idle):
                return False
            frozen = self._kickoff()

        def _run():
            try:
                gen = self._build(child, version, staged_idx, frozen)
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

    def swap_if_ready(self, gate=None) -> bool:
        """Atomically publish a completed shadow generation.  Called between
        train steps — never concurrently with a reader holding a snapshot.
        On a mesh it publishes only when every rank's build has finished,
        so every rank swaps at the same call, and publishes on no rank when
        a build failed on any (each raises).  ``gate`` (mesh only: a
        context-manager factory) is entered around the publish itself: a
        serving fabric orders it against its workers' sampling there."""
        if self.mesh is not None:
            with self._lock:
                ready = (self._shadow is not None
                         or self._refresh_err is not None)
                ok = self._refresh_err is None
            if not self._agree(ready):
                return False
            if not self._agree(ok):
                with self._lock:
                    err, self._refresh_err = self._refresh_err, None
                    self._shadow = None
                raise err if err is not None else RuntimeError(
                    "the generation build failed on another rank of the "
                    "mesh; no rank publishes it")
            with (gate() if gate is not None else contextlib.nullcontext()):
                with self._lock:
                    self._live, self._shadow = self._shadow, None
                    self.swaps += 1
            return True
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

    def join_build(self, timeout: Optional[float] = None) -> bool:
        """Wait for a generation build in flight to end, without publishing
        it (a server shutting down); True when none is running."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
        return t is None or not t.is_alive()

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
