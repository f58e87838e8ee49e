"""Declarative engine configuration (port of ``repro.gns.config``).

``EngineConfig`` is the single description of a GNS run — dataset, sampler,
cache/placement, mesh, model, optimizer and serving sub-configs — that
:class:`repro_torch.gns.engine.GNSEngine` turns into the wired pipeline
(FeatureStore → sampler → forward).  The dataclasses are field-for-field
the reference's, so the JSON that ``repro.gns.config.EngineConfig.to_dict``
writes loads here unchanged through :meth:`EngineConfig.from_dict`, and the
JSON written here loads there.  ``MeshConfig`` of more than one position
makes the engine a rank of a ``torch.distributed`` world
(:mod:`repro_torch.launch.mesh`; :class:`repro_torch.gns.engine
.GNSEngine` explains the split).

In ``ModelConfig``, ``aggregate_impl="pallas"`` and ``input_impl="fused"``
select the port's CUDA kernels (K2 ``gather_agg`` and K1
``cache_lookup_agg``), which is what the reference's names select on a TPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

import torch

from repro_torch.core.sampler import SamplerConfig
from repro_torch.featurestore import CacheConfig
from repro_torch.optim.adam import AdamConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Named synthetic dataset (repro_torch.graph.datasets) + scale."""
    name: str = "ogbn-products"
    scale: float = 0.5
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative host mesh: (data, model) axis sizes.

    The port runs one process per mesh position: the engine builds its
    :class:`~repro_torch.launch.mesh.HostMesh` over the process group the
    caller started, which must have ``data·model`` ranks.
    """
    data: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Declarative GraphSAGE dims; feat_dim / num_classes / num_layers are
    resolved from the dataset and sampler at build time (pass a concrete
    ``SageConfig`` to the engine to override everything)."""
    hidden_dim: int = 256
    aggregate_impl: str = "reference"   # "reference" | "pallas" (K2 kernel)
    input_impl: str = "where"           # "where" | "fused" (K1 kernel)
    input_kernel: str = "pallas"        # carried as data: the port runs K1
                                        # on a CUDA device and its plain
                                        # version on the CPU, whatever this
                                        # names
    sample_kernel: str = "auto"         # carried as data: the device
                                        # backend runs K3 on a CUDA device
                                        # and its plain version on the CPU


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One serving tenant: its fair-share weight and its admission quota.

    ``weight`` sets the tenant's share of worker throughput under
    saturation (stride scheduling: a weight-2 tenant is dequeued twice as
    often as a weight-1 tenant).  ``max_queue`` bounds how many of the
    tenant's requests may wait on any ONE worker — the per-tenant
    backpressure that keeps a flooding tenant's QueueFull its own problem.
    """
    name: str
    weight: float = 1.0
    max_queue: int = 64


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Declarative multi-tenant serving fabric
    (``repro_torch.serve.ServeFabric``, built by
    ``GNSEngine.serve_fabric``), in process (``transport="inproc"``) or
    over TCP to one ``repro_torch.rpc.WorkerEndpoint`` process per worker
    (``transport="tcp"``).

    Scales the single ``GNSServer`` worker to a fleet over ONE shared cache
    generation: each worker owns a DP group (and therefore a home shard of
    the sharded cache), requests are routed to the worker whose shard owns
    their hot rows, and per-tenant weighted-fair queues isolate tenants
    from each other's bursts.
    """
    workers: int = 2                # fleet size; worker i serves DP group i
    tenants: Sequence[TenantConfig] = ()
                                    # declared tenants; unknown tenants are
                                    # auto-registered with the defaults below
    default_weight: float = 1.0
    default_quota: int = 64         # per-tenant per-worker queue bound for
                                    # auto-registered tenants
    routing: str = "locality"       # "locality" (placement-derived routing
                                    # table + ownership vote) | "spread"
                                    # (least-loaded, ignores the table)
    stall_timeout_ms: float = 1000.0
                                    # a worker whose heartbeat is older than
                                    # this while it owes work is STALLED:
                                    # routed around + its queue re-routed
    watch_interval_ms: float = 20.0
                                    # watchdog poll period (health checks,
                                    # generation swaps, refresh kicks)
    max_retries: int = 2            # failover re-routes per request before
                                    # its future fails with WorkerDown
    transport: str = "inproc"       # "inproc" (threads over one cache) |
                                    # "tcp" (each worker a proxy to an
                                    # endpoint process with its own cache
                                    # replica)
    endpoints: Sequence[str] = ()   # "host:port" per worker (tcp transport;
                                    # len must equal ``workers``)
    heartbeat_ms: float = 100.0     # endpoint heartbeat period; beat ages
                                    # feed the SAME stall_timeout_ms watchdog
                                    # rule as in-proc workers
    connect_timeout_ms: float = 5000.0
                                    # per-attempt TCP connect timeout
    connect_retries: int = 5        # bounded reconnect attempts with
                                    # exponential backoff + deterministic
                                    # (seeded) jitter
    connect_backoff_ms: float = 50.0
                                    # backoff base: attempt k sleeps
                                    # base * 2^k * (1 + 0.25*jitter)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Declarative serving sub-block (``repro_torch.serve.GNSServer``).

    ``buckets`` are the ONLY padded inference-batch sizes the server ever
    ships to the device: the micro-batcher coalesces queued requests and pads
    to the smallest bucket that holds them, so the kernels see one fixed set
    of shapes per bucket (``GNSEngine.infer_prepare`` / ``infer_compute``).
    """
    buckets: Sequence[int] = (32, 128, 512)
                                    # ascending padded batch sizes; the
                                    # largest is the per-step id budget
    max_queue: int = 256            # admission control: queued requests
                                    # beyond this are REJECTED (QueueFull)
    max_wait_ms: float = 2.0        # micro-batch coalescing window: how long
                                    # the batcher holds the first request of
                                    # a batch while more arrive
    default_deadline_ms: Optional[float] = None
                                    # per-request deadline (ms from submit);
                                    # requests still queued past it complete
                                    # as "expired" without touching the
                                    # device.  None = no deadline.
    refresh_every: Optional[int] = None
                                    # kick an async cache refresh every N
                                    # served batches, so the adaptive policy
                                    # (fed by serving traffic) re-draws the
                                    # generation toward the INFERENCE hot
                                    # set.  None = never refresh while
                                    # serving.
    latency_window: int = 2048      # rolling per-request latency records
                                    # kept for the p50/p99 view
    fabric: Optional[FabricConfig] = None
                                    # multi-tenant fleet settings; None means
                                    # ``GNSEngine.serve_fabric()`` falls back
                                    # to FabricConfig() defaults


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """ONE async-refresh schedule for every surface that kicks refreshes.

    Before this, the training path (``CacheConfig.period`` /
    ``async_refresh``) and the serving path (``ServeConfig.refresh_every``)
    were configured independently and could disagree on whether refreshes
    run at all.  ``EngineConfig.refresh`` is the single hint: when set, it
    overrides the corresponding fields of both sub-configs at build time
    (:meth:`EngineConfig.cache_config` / :meth:`EngineConfig.serve_config`).
    When ``None``, the sub-configs stand alone exactly as before.
    """
    period: int = 1                 # training: refresh every N epochs
    async_refresh: bool = False     # training: build next gen off-thread
    serve_every: Optional[int] = None
                                    # serving: async refresh every N served
                                    # batches (None = never while serving)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Declarative streaming-ingest sub-block (``repro_torch.stream``; the
    engine attaches a ``DeltaBuffer`` to its store when this is set).

    Governs the :class:`~repro_torch.stream.DeltaBuffer` the engine's
    ``ingest()`` surface stages edge/node deltas into, and when/how the
    store folds them into the live structure.  Deltas are merged ONLY at a
    generation boundary (``FeatureStore._build``), so the atomic swap that
    already carries features carries structure too — in-flight batches
    stay pinned to the pre-merge generation, bitwise-identical.
    """
    max_pending: int = 4096         # DeltaBuffer admission bound: ops staged
                                    # beyond this are REJECTED (QueueFull —
                                    # the serving tier's discipline)
    merge_min_pending: int = 1      # the fabric watchdog kicks a merging
                                    # refresh once this many ops are buffered
    incremental_placement: bool = True
                                    # locality re-solve touches only rows
                                    # whose traffic/degree changed since the
                                    # last solve (bounded migration set);
                                    # False = full re-solve every generation
    symmetrize: bool = True         # mirror each delta op (undirected CSR —
                                    # matches CSRGraph.from_edges)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One declarative description of a GNS run (see module docstring)."""
    sampler: str = "gns"                # ns | gns | ladies | lazygcn
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    sampling: SamplerConfig = dataclasses.field(
        default_factory=lambda: SamplerConfig(batch_size=256))
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: AdamConfig = dataclasses.field(
        default_factory=lambda: AdamConfig(lr=3e-3))
    mesh: Optional[MeshConfig] = None
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    refresh: Optional[RefreshConfig] = None
                                        # unified refresh hint (overrides
                                        # cache.period/async_refresh AND
                                        # serve.refresh_every when set)
    stream: Optional[StreamConfig] = None
                                        # streaming-ingest settings; None
                                        # still allows ``engine.ingest()``
                                        # (lazy-attached with defaults)
    seed: int = 0
    prefetch: bool = False              # fit() default (overridable per call)

    # ------------------------------------------------------------------
    def cache_config(self) -> CacheConfig:
        """``EngineConfig.cache`` with the unified refresh hint applied."""
        if self.refresh is None:
            return self.cache
        return dataclasses.replace(self.cache, period=self.refresh.period,
                                   async_refresh=self.refresh.async_refresh)

    def serve_config(self) -> ServeConfig:
        """``EngineConfig.serve`` with the unified refresh hint applied."""
        if self.refresh is None:
            return self.serve
        return dataclasses.replace(self.serve,
                                   refresh_every=self.refresh.serve_every)

    def sampler_config(self) -> SamplerConfig:
        """The sampler config with THE cache config injected — the one
        object handed to ``make_sampler``/``FeatureStore`` so
        ``EngineConfig.cache`` and ``sampling.cache`` cannot diverge (and,
        via :meth:`cache_config`, so the refresh hint reaches the sampler
        path too)."""
        return dataclasses.replace(self.sampling, cache=self.cache_config())

    # ------------------------------------------------------------------
    # dict round-trip (JSON-safe)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        md = d["optim"]["moment_dtype"]
        if isinstance(md, torch.dtype):     # same names as the reference
            d["optim"]["moment_dtype"] = str(md).removeprefix("torch.")
        elif not isinstance(md, str):
            d["optim"]["moment_dtype"] = np.dtype(md).name
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        return _build(cls, d)

    # ------------------------------------------------------------------
    @classmethod
    def preset(cls, name: str, **overrides) -> "EngineConfig":
        """A named baseline config, optionally overridden field-by-field.

        Overrides are top-level ``EngineConfig`` fields (sub-configs are
        replaced whole — use ``dataclasses.replace`` on the result for
        field-level tweaks).
        """
        base = PRESETS[name]
        return dataclasses.replace(base, **overrides) if overrides else base


# ---------------------------------------------------------------------------
# nested reconstruction
# ---------------------------------------------------------------------------

_TUPLE_FIELDS = {"fanouts", "walk_fanouts", "buckets", "endpoints"}
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


def _moment_dtype(name: str) -> torch.dtype:
    return _MOMENT_DTYPES.get(name, torch.float32)


def _build(cls_, d):
    """Rebuild a (possibly nested) frozen dataclass from its asdict form."""
    if d is None:
        return None
    kw = {}
    for f in dataclasses.fields(cls_):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _NESTED.get((cls_, f.name))
        seq_sub = _NESTED_SEQ.get((cls_, f.name))
        if sub is not None:
            kw[f.name] = _build(sub, v)
        elif seq_sub is not None and v is not None:
            kw[f.name] = tuple(
                _build(seq_sub, el) if isinstance(el, dict) else el
                for el in v)
        elif f.name in _TUPLE_FIELDS and v is not None:
            kw[f.name] = tuple(v)
        elif cls_ is AdamConfig and f.name == "moment_dtype" \
                and isinstance(v, str):
            kw[f.name] = _moment_dtype(v)
        else:
            kw[f.name] = v
    return cls_(**kw)


_NESTED = {
    (EngineConfig, "data"): DataConfig,
    (EngineConfig, "sampling"): SamplerConfig,
    (EngineConfig, "cache"): CacheConfig,
    (EngineConfig, "model"): ModelConfig,
    (EngineConfig, "optim"): AdamConfig,
    (EngineConfig, "mesh"): MeshConfig,
    (EngineConfig, "serve"): ServeConfig,
    (EngineConfig, "refresh"): RefreshConfig,
    (EngineConfig, "stream"): StreamConfig,
    (SamplerConfig, "cache"): CacheConfig,
    (ServeConfig, "fabric"): FabricConfig,
}

# sequence-of-dataclass fields: rebuilt element-wise into a tuple
_NESTED_SEQ = {
    (FabricConfig, "tenants"): TenantConfig,
}


# ---------------------------------------------------------------------------
# presets — the reference's, value for value (the comments name where the
# reference uses each)
# ---------------------------------------------------------------------------

PRESETS: dict = {
    # examples/quickstart.py: laptop-scale GNS-vs-NS comparison
    "quickstart": EngineConfig(
        sampler="gns",
        data=DataConfig(name="ogbn-products", scale=1.0),
        sampling=SamplerConfig(batch_size=128, fanouts=(5, 10, 15)),
        cache=CacheConfig(fraction=0.05, period=1)),
    # examples/train_gns_graphsage.py: the paper's §4.1 training setup
    "paper_train": EngineConfig(
        sampler="gns",
        data=DataConfig(name="ogbn-products", scale=0.5),
        sampling=SamplerConfig(batch_size=1000, fanouts=(5, 10, 15)),
        cache=CacheConfig(fraction=0.01, period=1)),
    # benchmarks/common.run_trainer: CI-scale harness defaults.  The cache
    # fraction matches the paper's 1% COVERAGE at reduced scale.
    "bench_ci": EngineConfig(
        sampler="gns",
        data=DataConfig(name="ogbn-products", scale=0.25),
        sampling=SamplerConfig(batch_size=512, fanouts=(5, 10, 15),
                               layer_size=512),
        cache=CacheConfig(fraction=0.05, period=1)),
    # benchmarks/bench_stream.py + the temporal-event replay scenario:
    # serve-while-mutating with locality placement over a sharded cache,
    # deltas drained by the fabric watchdog at generation boundaries
    "stream_replay": EngineConfig(
        sampler="gns",
        data=DataConfig(name="ogbn-products", scale=0.25),
        sampling=SamplerConfig(batch_size=256, fanouts=(5, 10)),
        cache=CacheConfig(fraction=0.05, strategy="adaptive",
                          placement="locality", shards=2),
        serve=ServeConfig(buckets=(32, 128), max_wait_ms=2.0),
        stream=StreamConfig(merge_min_pending=1)),
}
