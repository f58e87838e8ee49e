"""GNSEngine (port of ``repro.gns.engine.GNSEngine``).

One object owns the wiring

    FeatureStore  →  sampler  →  EpochLoader / Prefetcher  →  step

built from one declarative :class:`~repro_torch.gns.config.EngineConfig`
(the reference's JSON loads unchanged), and exposes the verbs:

* :meth:`fit`           — the paper's §2.2 training loop (sample → slice →
  copy → compute) with the Fig. 1/2 time and traffic breakdown on the
  meter;
* :meth:`evaluate`      — micro-F1 over held-out targets (meter suspended);
* :meth:`infer`         — mini-batch inference reusing the LIVE cache
  generation: logits for arbitrary node ids, no refresh beyond the cold
  start, no accounting;
* :meth:`infer_prepare` / :meth:`infer_compute` — the two halves
  :class:`~repro_torch.serve.GNSServer` drives per micro-batch;
* :meth:`serve`         — a :class:`~repro_torch.serve.GNSServer` over
  this engine;
* :meth:`serve_fabric`  — a multi-tenant, multi-worker
  :class:`~repro_torch.serve.ServeFabric` over this engine;
* :meth:`ingest` / :meth:`ingest_nodes` / :meth:`ingest_events` /
  :meth:`merge_deltas` — streaming ingest: stage edge and node deltas
  (:mod:`repro_torch.stream`), merged into the graph at the next cache
  generation;
* :meth:`describe`      — the traffic record of this config
  (:func:`repro_torch.gns.describe.traffic_report`);
* :meth:`save` / :meth:`restore` — parameters, optimizer state and the
  un-merged delta log through :mod:`repro_torch.checkpoint`, in the
  reference's format.

The reference's jit'd train step is eager here: forward, ``loss.backward``
through ``torch.autograd.grad`` (:func:`graphsage.value_and_grad`) and the
repo's own AdamW, with TF32 off on the card.  Its logits and eval steps
are forwards under ``torch.inference_mode()``.  With
``SamplerConfig(backend="device")`` layer 0 is drawn on the device (kernel
K3); with ``ModelConfig(input_impl="fused")`` on the host backend it runs
through kernel K1.  Every sampler of the reference trains here: ``gns``,
``ns``, ``ladies`` and ``lazygcn``.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without ``device=`` it raises rather than run on the
CPU.

**On a mesh** (``EngineConfig.mesh`` of ``data × model`` > 1, or a
:class:`~repro_torch.launch.mesh.HostMesh` passed in): one engine per
process, each rank at position ``(d, m)`` of the mesh; the caller starts
the process group (``launch.mesh.run_ranks`` in the tests and
``chip_smoke.py``), and the engine raises without one of ``data·model``
ranks.  Rank ``(d, m)`` holds cache shard ``m`` and trains data-parallel
group ``d``:

* the store uploads only shard ``m``'s rows, and every rank builds the
  same generations and swaps them at the same step (``featurestore
  .store``);
* the loader yields group ``d``'s batches only — batch ``i`` belongs to
  group ``i % data``, sampled with the batch index's RNG, so the ranks of
  one group sample the same batch — and layer 0 runs per shard (K1 or K3)
  with its partials combined over the cache group; the per-group home
  shard (``MiniBatch.local_shard``) drives the locality fast path;
* the loss is each group's masked NLL sum over the label count of ALL
  groups (summed over the data group), so the groups' losses and
  gradients sum to the reference's over the collated batch
  (:func:`collate_groups`, its single-process form); the gradients are
  summed over the data group, every rank of a group takes its shard-0
  rank's sum, and AdamW runs identically on every rank;
* ``evaluate`` and ``infer`` are SPMD: every rank calls them with the same
  ids and gets the same answer;
* ``serve`` and ``serve_fabric`` are built, started and stopped on every
  rank; the leader (global rank 0) takes the requests and every rank runs
  every batch (``repro_torch.serve``);
* ``ingest``, ``ingest_nodes`` and ``ingest_events`` stage on the leader
  only (:class:`~repro_torch.launch.mesh.NotLeader` elsewhere); every
  rank merges the leader's deltas at the same generation
  (``featurestore.store``), and ``merge_deltas`` is SPMD;
* ``save`` is called on every rank: the leader writes the reference's
  format (parameters, moments, its delta log; nothing of the cache, which
  is rebuilt from the seed) and every rank returns its directory;
  ``restore`` reads the same files on every rank, and the leader re-stages
  the delta log.

Over ``FabricConfig(transport="tcp")`` each endpoint holds its own engine
replica; on a mesh each endpoint is a world of ranks of its own
(``repro_torch.rpc.endpoint``).  The coordinator is one process, as in the
reference: :meth:`GNSEngine.coordinator` builds its engine without the
mesh, and its fabric proxies to the endpoints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core.minibatch import DeviceBatch, LayerBlock, MiniBatch
from repro_torch.core.pipeline import EpochLoader, Prefetcher
from repro_torch.core.sampler import (GNSSampler, LazyGCNSampler,
                                      make_sampler)
from repro_torch.device import resolve_device
from repro_torch.featurestore import FeatureStore, TrafficMeter
from repro_torch.gns.config import EngineConfig
from repro_torch.gns.describe import (describe_lowering, mesh_report,
                                     traffic_report)
from repro_torch.graph.datasets import get_dataset
from repro_torch.kernels.ops import (dp_axes, dp_group_count, dp_group_index,
                                     psum)
from repro_torch.launch.collectives import broadcast
from repro_torch.launch.mesh import NotLeader, broadcast_object
from repro_torch.launch.sharding import use_mesh
from repro_torch.models import graphsage
from repro_torch.optim.adam import AdamW


@dataclasses.dataclass
class TrainReport:
    epoch_times: list
    losses: list
    val_acc: list
    meter: TrafficMeter
    input_nodes_per_batch: float = 0.0
    cached_nodes_per_batch: float = 0.0
    isolated_per_batch: float = 0.0


def collate_groups(mbs: Sequence[MiniBatch], fused: bool
                   ) -> tuple[MiniBatch, np.ndarray]:
    """Collate one MiniBatch per DP group into a single step batch (the
    single-process form of the DP regime; the port's oracle for a mesh).

    Group-order concatenation of every device array; block pads stay
    PER-GROUP (``SageConfig.num_groups`` tells the model to gather each
    group's leading rows instead of slicing a global prefix).  Gather
    indices are group-local per assembly, so upper-layer blocks — consumed
    by GLOBAL gathers in the model — are offset by ``g·num_src``; the input
    block stays group-local when the fused op consumes it per group
    (``fused``) and is offset otherwise.

    Returns the collated batch plus the int32 home-shard vector (one entry
    per group, -1 where the group's batch had no locality contract).  All
    batches must carry the SAME cache generation.
    """
    if len(mbs) == 1:
        mb = mbs[0]
        ls = mb.local_shard if mb.local_shard is not None else -1
        return mb, np.array([ls], np.int32)
    gens = {mb.cache_gen.version if mb.cache_gen is not None else -1
            for mb in mbs}
    if len(gens) != 1:
        raise ValueError(f"step spans cache generations {gens}")
    blocks = []
    for li in range(len(mbs[0].device.blocks)):
        bs = [mb.device.blocks[li] for mb in mbs]
        s, d = bs[0].num_src, bs[0].num_dst
        offset = li > 0 or not fused
        blocks.append(LayerBlock(
            nbr_idx=np.concatenate(
                [b.nbr_idx + (g * s if offset else 0)
                 for g, b in enumerate(bs)]).astype(np.int32),
            nbr_w=np.concatenate([b.nbr_w for b in bs]),
            dst_mask=np.concatenate([b.dst_mask for b in bs]),
            num_src=s, num_dst=d))

    def _cat(field):
        vals = [getattr(mb.device, field) for mb in mbs]
        return None if vals[0] is None else np.concatenate(vals)

    dev = DeviceBatch(
        blocks=tuple(blocks),
        input_cache_slots=_cat("input_cache_slots"),
        input_streamed=_cat("input_streamed"),
        input_mask=_cat("input_mask"),
        labels=_cat("labels"),
        label_mask=_cat("label_mask"),
        # device-backend fields: fallback lanes concat like any row array;
        # the [1, 2] per-batch keys stack to [G, 2]
        input_fb_rows=_cat("input_fb_rows"),
        input_fb_w=_cat("input_fb_w"),
        sample_key=_cat("sample_key"))
    home = np.array([mb.local_shard if mb.local_shard is not None else -1
                     for mb in mbs], np.int32)
    out = MiniBatch(
        device=dev,
        input_node_ids=np.concatenate([mb.input_node_ids for mb in mbs]),
        num_input=sum(mb.num_input for mb in mbs),
        num_cached=sum(mb.num_cached for mb in mbs),
        bytes_streamed=sum(mb.bytes_streamed for mb in mbs),
        num_isolated=sum(mb.num_isolated for mb in mbs),
        cache_gen=mbs[0].cache_gen)
    return out, home


def make_train_step(mcfg: graphsage.SageConfig, opt: AdamW, mesh=None):
    """The engine's device step (the reference's ``make_train_step``):
    ``train_step(params, opt_state, batch, cache_table, home_shards,
    device_adj=None) -> (params, opt_state, loss, acc)``, forward,
    backward and AdamW in place.

    On a ``mesh`` (this rank's view; ``batch`` is its data-parallel
    group's), ``home_shards`` is the per-group home-shard vector (-1:
    none) that gates the fused input's fast path; the label count, the
    loss, the accuracy and the gradients are summed over the data-parallel
    groups, and every rank applies its group's shard-0 rank's sums (the
    card's unordered sums may differ in the last bits between the ranks
    of a group, so the parameters stay equal everywhere)."""
    axis = mcfg.cache_shard_axis
    dp = dp_axes(mesh, axis) if mesh is not None else ()

    def dp_sum(t: torch.Tensor) -> torch.Tensor:
        for a in dp:
            psum(t, mesh, a)
        return t

    def train_step(params, opt_state, batch, cache_table, home_shards,
                   device_adj=None):
        count = None
        if mesh is not None:
            count = dp_sum(batch.label_mask.sum().reshape(1))[0]
        with use_mesh(mesh):
            loss, acc, grads = graphsage.value_and_grad(
                params, batch, cache_table, mcfg, device_adj=device_adj,
                local_shard=home_shards, label_count=count)
        if mesh is not None and mesh.size > 1:
            leaves = [g for layer in grads["layers"] for g in layer.values()]
            flat = dp_sum(torch.cat([loss.reshape(1), acc.reshape(1)]
                                    + [g.reshape(-1) for g in leaves]))
            for a in mesh.axis_names:
                if a not in dp and mesh.shape[a] > 1:
                    broadcast(flat, mesh.rank_at(a, 0), mesh.group(a))
            loss, acc = flat[0], flat[1]
            parts = flat[2:].split([g.numel() for g in leaves])
            it = iter(p.view_as(g) for p, g in zip(parts, leaves))
            grads = {"layers": [{k: next(it) for k in layer}
                                for layer in grads["layers"]]}
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss, acc

    return train_step


class GNSEngine:
    """The wired pipeline for one :class:`EngineConfig`."""

    def __init__(self, cfg: EngineConfig, *, device=None, dataset=None,
                 model_cfg: Optional[graphsage.SageConfig] = None,
                 mesh=None, cache_shard_axis: Optional[str] = None):
        """``device`` defaults to ``cuda``; ``dataset`` and ``model_cfg``
        override the declarative ``cfg.data`` and ``cfg.model`` with a
        built dataset and a :class:`graphsage.SageConfig`, and ``mesh``
        (a :class:`~repro_torch.launch.mesh.HostMesh`) overrides
        ``cfg.mesh`` (as the reference's do; the ``GNNTrainer`` shim's
        path)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        if mesh is None and cfg.mesh is not None \
                and cfg.mesh.data * cfg.mesh.model > 1:
            from repro_torch.launch.mesh import make_host_mesh
            mesh = make_host_mesh(cfg.mesh.data, cfg.mesh.model)
        self.mesh = mesh
        if dataset is None:
            dataset = get_dataset(cfg.data.name, scale=cfg.data.scale,
                                  seed=cfg.data.seed)
        self.ds = dataset
        self.seed = cfg.seed
        self.scfg = cfg.sampler_config()
        if self.scfg.backend == "device" and cfg.sampler != "gns":
            raise ValueError("backend='device' is the GNS device sampler; "
                             f"sampler={cfg.sampler!r} has none")
        if model_cfg is None:
            m = cfg.model
            model_cfg = graphsage.SageConfig(
                feat_dim=self.ds.feat_dim, hidden_dim=m.hidden_dim,
                num_classes=self.ds.num_classes,
                num_layers=len(self.scfg.fanouts),
                aggregate_impl=m.aggregate_impl, input_impl=m.input_impl,
                sample_kernel=m.sample_kernel)
        self.mcfg = model_cfg
        self.meter = TrafficMeter()
        # eval and one-shot inference book their copy time on side meters,
        # never on the training breakdown
        self.meter_eval = TrafficMeter()
        self.meter_infer = TrafficMeter()
        if cfg.sampler == "gns":
            # the facade owns all three feature tiers + the refresh lifecycle
            self.store = FeatureStore(
                self.ds.features, self.ds.graph, self.scfg.cache,
                device=self.device, train_idx=self.ds.train_idx,
                meter=self.meter, importance_mode=self.scfg.importance_mode,
                build_adjacency=True, mesh=mesh,
                shard_axis=cache_shard_axis, seed=cfg.seed)
        else:
            self.store = None
        if self.store is not None and mesh is not None \
                and self.mcfg.cache_shard_axis is None:
            # each rank holds its shard only, so every read of the table
            # (K1, K3, or the rows of h0 itself) goes through the cache axis
            self.mcfg = dataclasses.replace(
                self.mcfg, cache_shard_axis=self.store.shard_axis)
        # DP groups: one minibatch per group per step; on a mesh each rank
        # trains its own group's, so its model sees one group per batch
        self.num_groups = dp_group_count(mesh, self.mcfg.cache_shard_axis)
        self.group = (dp_group_index(mesh, self.mcfg.cache_shard_axis)
                      if mesh is not None else 0)
        if self.store is not None:
            self.store.dp_group = self.group
        self.sampler = make_sampler(cfg.sampler, self.ds.graph, self.scfg,
                                    self.ds.features, self.ds.labels,
                                    train_idx=self.ds.train_idx,
                                    store=self.store)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = graphsage.init_params(self.mcfg, gen, self.device)
        self.opt = AdamW(cfg.optim)
        self.opt_state = self.opt.init(self.params)
        self._train_step = make_train_step(self.mcfg, self.opt, mesh)
        self._dummy_cache = graphsage.dummy_cache_table(self.ds.feat_dim,
                                                        self.device)
        # a recycling sampler (LazyGCN) hands the same host arrays out again:
        # (host DeviceBatch, its device copy) of the last fresh training
        # batch, so a recycled step copies nothing, as its meter books
        self._held_batch = None
        # serving-shaped inference: one sampler per padded batch size
        # ("bucket"), all sharing THE store, so every bucket rides the same
        # live cache generation and feeds the same policy signals
        self._bucket_samplers: dict = {}
        # streaming ingest: wired now when the config declares it, on the
        # first ingest() otherwise
        self._stream = None
        if cfg.stream is not None and self.store is not None:
            self._init_stream(cfg.stream)

    # ------------------------------------------------------------------
    def _cache_table(self, mb: MiniBatch) -> torch.Tensor:
        """The device table the batch's slots index into: the one of the
        generation the batch pinned, so a swap can never tear a batch."""
        return mb.cache_gen.table if mb.cache_gen is not None \
            else self._dummy_cache

    @staticmethod
    def _device_adj(mb: MiniBatch):
        """The batch's pinned generation's device CSR (None on the host
        backend), resolved like :meth:`_cache_table`, so a batch draws from
        the generation it gathers from."""
        gen = mb.cache_gen
        return gen.device_adj if gen is not None else None

    def _put_batch(self, mb: MiniBatch, meter: TrafficMeter,
                   hold: bool = False):
        """Host -> device copy of the batch, its wall time booked on
        ``meter`` (the copies are queued, not waited for, on a GPU).  A
        batch whose host arrays are the held batch's (a recycled LazyGCN
        batch) reuses the held copy; ``hold`` keeps this copy for that."""
        held = self._held_batch
        if held is not None and held[0] is mb.device:
            return held[1]
        t0 = time.perf_counter()
        out = mb.device.to(self.device)
        meter.t_copy += time.perf_counter() - t0
        if hold:
            self._held_batch = (mb.device, out)
        return out

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def run_batch(self, mb: MiniBatch) -> tuple[float, float]:
        """One optimizer step: forward, backward, AdamW.  Returns (loss,
        accuracy).  ``t_compute`` includes the sync that reading the loss
        forces, so it is the device time of the step plus its launches.

        On a mesh ``mb`` is this rank's group's batch, its home shard
        (``mb.local_shard``) gates the fused input's fast path, and the
        loss and accuracy returned are the step's over every group."""
        m = self.meter
        dev_batch = self._put_batch(
            mb, m, hold=isinstance(self.sampler, LazyGCNSampler))
        m.add_batch(mb.bytes_streamed)
        t0 = time.perf_counter()
        home_shards = None
        if self.mesh is not None:
            home_shards = np.full(self.num_groups, -1, np.int32)
            if mb.local_shard is not None:
                home_shards[self.group] = mb.local_shard
        self.params, self.opt_state, loss, acc = self._train_step(
            self.params, self.opt_state, dev_batch, self._cache_table(mb),
            home_shards, self._device_adj(mb))
        loss = loss.item()
        m.t_compute += time.perf_counter() - t0
        return loss, acc.item()

    def fit(self, epochs: int, max_batches: Optional[int] = None,
            prefetch: Optional[bool] = None,
            eval_every: Optional[int] = None,
            eval_batches: int = 8) -> TrainReport:
        """The §2.2 training loop; ``max_batches`` bounds steps per epoch
        (on a mesh of G data-parallel groups a step takes G minibatches, one
        per group, and this rank trains its own group's)."""
        if prefetch is None:
            prefetch = self.cfg.prefetch
        G = self.num_groups
        loader = EpochLoader(self.sampler, self.ds.train_idx, seed=self.seed,
                             max_batches=(max_batches * G if max_batches
                                          is not None else None),
                             dp_groups=G,
                             group=self.group if self.mesh is not None
                             else None)
        report = TrainReport([], [], [], self.meter)
        n_inputs, n_cached, n_iso, n_b = 0, 0, 0, 0
        for ep in range(epochs):
            t_ep = time.perf_counter()
            # start_epoch drops the sampler's megabatch: no later batch
            # shares the held one's arrays
            self._held_batch = None
            # epoch start (the cache refresh happens in start_epoch)
            it = loader.epoch(ep)
            if prefetch:
                it = Prefetcher(it, depth=2, meter=self.meter)
            else:
                it = self._timed(it)
            ep_losses = []
            for mb in it:
                loss, _ = self.run_batch(mb)
                ep_losses.append(loss)
                n_inputs += mb.num_input
                n_cached += mb.num_cached
                n_iso += mb.num_isolated
                n_b += 1
            report.epoch_times.append(time.perf_counter() - t_ep)
            report.losses.append(float(np.mean(ep_losses)) if ep_losses
                                 else float("nan"))
            if eval_every and (ep + 1) % eval_every == 0:
                report.val_acc.append(
                    self.evaluate(self.ds.val_idx, eval_batches))
        if n_b:
            report.input_nodes_per_batch = n_inputs / n_b
            report.cached_nodes_per_batch = n_cached / n_b
            report.isolated_per_batch = n_iso / n_b
        return report

    def _timed(self, it):
        """Wrap a batch iterator, attributing wall time to meter.t_sample.

        The store books the host gather inside ``sample`` to meter.t_slice
        and (sync-mode) cache builds inside ``start_epoch`` to
        meter.t_refresh; both deltas are subtracted so each second lands in
        exactly one bucket (clamped at zero: an async build finishing in a
        short window could otherwise over-subtract).
        """
        it = iter(it)
        while True:
            t0 = time.perf_counter()
            slice0 = self.meter.t_slice
            refresh0 = self.meter.t_refresh
            try:
                mb = next(it)
            except StopIteration:
                return
            elapsed = time.perf_counter() - t0
            self.meter.t_sample += max(
                elapsed - (self.meter.t_slice - slice0)
                - (self.meter.t_refresh - refresh0), 0.0)
            yield mb

    def evaluate(self, idx: Optional[np.ndarray] = None,
                 num_batches: int = 8) -> float:
        """Micro-F1 (= accuracy for single-label tasks, as in the paper)."""
        if idx is None:
            idx = self.ds.val_idx
        b = self.scfg.batch_size
        idx = np.asarray(idx)
        if len(idx) < b:  # pad by wrapping; the mask handles the weight
            idx = np.concatenate([idx, idx[: b - len(idx)]])
        rng = np.random.default_rng(1234)
        self.ensure_cache(rng)
        if self.store is not None:
            self.store.record = False   # eval must not skew training metrics
                                        # or the adaptive policy's miss EMA
        correct, total = 0.0, 0.0
        try:
            for i in range(num_batches):
                lo = (i * b) % (len(idx) - b + 1)
                mb = self.sampler.sample(idx[lo:lo + b], rng)
                dev_batch = self._put_batch(mb, self.meter_eval)
                with torch.inference_mode(), use_mesh(self.mesh):
                    _, acc = graphsage.loss_fn(
                        self.params, dev_batch, self._cache_table(mb),
                        self.mcfg, device_adj=self._device_adj(mb))
                correct += acc.item()
                total += 1.0
        finally:
            if self.store is not None:
                self.store.record = True
        return correct / max(total, 1.0)

    # ------------------------------------------------------------------
    # serving-shaped inference (the repro_torch.serve engine surface)
    # ------------------------------------------------------------------
    def _bucket_sampler(self, bucket: int):
        """A sampler whose padded shapes are sized for ``bucket`` targets
        (one instance per bucket, never ``self.sampler``, all sharing
        ``self.store``)."""
        s = self._bucket_samplers.get(bucket)
        if s is None:
            scfg = dataclasses.replace(self.scfg, batch_size=int(bucket))
            s = make_sampler(self.cfg.sampler, self.ds.graph, scfg,
                             self.ds.features, self.ds.labels,
                             train_idx=self.ds.train_idx, store=self.store)
            self._bucket_samplers[bucket] = s
        return s

    def ensure_cache(self, rng: Optional[np.random.Generator] = None) -> None:
        """Cold-start the cache generation (no-op for storeless samplers)."""
        if isinstance(self.sampler, GNSSampler):
            self.sampler.ensure_cache(rng)

    def infer_prepare(self, node_ids: np.ndarray, bucket: Optional[int] = None,
                      rng: Optional[np.random.Generator] = None,
                      sampler=None) -> MiniBatch:
        """Sample one inference minibatch padded to ``bucket`` targets.

        The batch PINS the cache generation it was assembled against
        (``MiniBatch.cache_gen``), so :meth:`infer_compute` reads a matching
        slot-map/table pair even if an async refresh swaps the live
        generation in between.  ``sampler`` overrides the per-bucket
        serving sampler (its pad sizes must match ``bucket``).
        """
        ids = np.asarray(node_ids, dtype=np.int64)
        if bucket is None:
            bucket = self.scfg.batch_size
        if len(ids) > bucket:
            raise ValueError(f"{len(ids)} ids exceed bucket {bucket}")
        if rng is None:
            rng = np.random.default_rng(4321)
        if sampler is None:
            sampler = self._bucket_sampler(bucket)
        elif sampler.cfg.batch_size != bucket:
            raise ValueError(f"sampler pads to {sampler.cfg.batch_size}, "
                             f"not bucket {bucket}")
        if isinstance(sampler, GNSSampler):
            if self.store.generation is None:
                self.ensure_cache(rng)
            sampler.adopt_generation()    # follow the live gen (monotonic)
        return sampler.sample(ids, rng)

    def infer_compute(self, mb: MiniBatch,
                      meter: Optional[TrafficMeter] = None,
                      mesh=None) -> np.ndarray:
        """Run the forward on a prepared batch.

        Returns logits ``[bucket, classes]`` (padded rows included — slice
        the leading real rows off).  ``meter`` receives the host->device
        copy time (default: the engine's inference side meter).  On a mesh
        ``mesh`` is the calling thread's fork of the engine's (its own
        process groups; a serving loop's), default the engine's own.
        """
        dev_batch = self._put_batch(
            mb, meter if meter is not None else self.meter_infer)
        with torch.inference_mode(), use_mesh(
                mesh if mesh is not None else self.mesh):
            logits = graphsage.forward(self.params, dev_batch,
                                       self._cache_table(mb), self.mcfg,
                                       device_adj=self._device_adj(mb))
        return logits.cpu().numpy()

    @classmethod
    def coordinator(cls, cfg: EngineConfig, *, device=None,
                    dataset=None) -> "GNSEngine":
        """The engine of a ``FabricConfig(transport="tcp")`` coordinator
        for ``cfg``: one process, as the reference runs it, whatever
        ``cfg.mesh`` says (each endpoint of a mesh config is the world of
        ranks).  The coordinator only routes, so its engine is built
        without the mesh, its cache in the mesh's shards (one per
        position on the ``model`` axis, ``launch.mesh.cache_shard_axis``):
        the router reads the shard count, and the routing tables come from
        the endpoints.  It starts no process group and no rank."""
        if cfg.mesh is not None and cfg.mesh.data * cfg.mesh.model > 1:
            cfg = dataclasses.replace(cfg, mesh=None, cache=dataclasses
                                      .replace(cfg.cache,
                                               shards=cfg.mesh.model))
        return cls(cfg, device=device, dataset=dataset)

    def serve(self, serve_cfg=None):
        """A :class:`repro_torch.serve.GNSServer` over this engine (not
        started); the default config goes through
        :meth:`EngineConfig.serve_config`.  On a mesh every rank calls it,
        in the same order (the server makes process groups of its own)."""
        from repro_torch.serve import GNSServer
        return GNSServer(self, serve_cfg if serve_cfg is not None
                         else self.cfg.serve_config())

    def serve_fabric(self, fabric_cfg=None, serve_cfg=None):
        """A :class:`repro_torch.serve.ServeFabric` fleet over this engine
        (not started).  Defaults come from ``EngineConfig.serve.fabric``
        (through :meth:`EngineConfig.serve_config`, so the unified refresh
        hint applies) — a bare ``FabricConfig()`` when unset.  On a mesh
        every rank calls it, in the same order."""
        from repro_torch.serve import ServeFabric
        return ServeFabric(self, cfg=fabric_cfg, serve_cfg=serve_cfg)

    def infer(self, node_ids: np.ndarray) -> np.ndarray:
        """Mini-batch inference over arbitrary node ids.  [N, classes] f32.

        Reuses the LIVE cache generation (no refresh beyond the cold-start
        one), suspends all traffic/policy accounting, and leaves the rest of
        the engine untouched.  For a request stream, use :meth:`serve`.
        """
        ids = np.asarray(node_ids, dtype=np.int64)
        b = self.scfg.batch_size
        rng = np.random.default_rng(4321)
        self.ensure_cache(rng)
        out = np.zeros((len(ids), self.mcfg.num_classes), np.float32)
        if self.store is not None:
            self.store.record = False
        try:
            for lo in range(0, len(ids), b):
                chunk = ids[lo:lo + b]
                targets = np.resize(chunk, b)    # wrap-pad the tail batch
                # one-shot path: reuse the engine's own sampler — a bucket
                # sampler here would duplicate its O(V) scratch for nothing
                mb = self.infer_prepare(targets, bucket=b, rng=rng,
                                        sampler=self.sampler)
                out[lo:lo + len(chunk)] = self.infer_compute(mb)[:len(chunk)]
        finally:
            if self.store is not None:
                self.store.record = True
        return out

    # ------------------------------------------------------------------
    # streaming ingest (repro_torch.stream)
    # ------------------------------------------------------------------
    def _init_stream(self, scfg=None):
        """Attach a :class:`repro_torch.stream.DeltaBuffer` to the store."""
        from repro_torch.gns.config import StreamConfig
        from repro_torch.stream import DeltaBuffer
        if self.store is None:
            raise ValueError(
                "streaming ingest rides the GNS feature store's generations; "
                f"sampler={self.cfg.sampler!r} has no store")
        if scfg is None:
            scfg = (self.cfg.stream if self.cfg.stream is not None
                    else StreamConfig())
        buf = DeltaBuffer(self.ds.graph.num_nodes, self.ds.feat_dim,
                          max_pending=scfg.max_pending)
        self.store.labels = self.ds.labels
        self.store.attach_stream(buf, scfg)
        self.store.add_merge_listener(self._on_merge)
        self._stream = buf
        return buf

    def _on_merge(self, store, batch) -> None:
        """Build-thread merge callback: re-point the engine's dataset view
        at the post-merge host tiers (reference swaps only — samplers adopt
        structure with the generation, at their own swap point)."""
        self.ds.graph = store.graph
        self.ds.features = store.features
        if store.labels is not None:
            self.ds.labels = store.labels

    @property
    def stream(self):
        """The delta staging buffer (created on first touch)."""
        return self._stream if self._stream is not None \
            else self._init_stream()

    def _staging_buffer(self):
        """The stream buffer, on the mesh's leader only."""
        if self.mesh is not None and not self.mesh.leader:
            raise NotLeader("ingest on a mesh goes to the leader (global "
                            "rank 0); every rank merges its deltas")
        return self.stream

    @property
    def pending_deltas(self) -> int:
        """Staged mutations awaiting the next generation merge."""
        return self.store.pending_deltas() if self.store is not None else 0

    def ingest(self, src, dst, op: str = "insert") -> int:
        """Stage edge mutations for the next generation merge.

        Non-blocking and thread-safe (serving stays live); raises
        :class:`repro_torch.serve.QueueFull` past ``stream.max_pending``.
        The edges become visible to sampling and serving only when a
        generation built after the merge is adopted — in-flight batches
        replay bitwise-identically against their pinned pre-merge
        generation.  Returns the first assigned sequence number.
        """
        buf = self._staging_buffer()
        if op == "insert":
            return buf.add_edges(src, dst)
        if op != "delete":
            raise ValueError(f"op must be insert|delete, got {op!r}")
        return buf.delete_edges(src, dst)

    def ingest_nodes(self, features: np.ndarray,
                     labels: Optional[np.ndarray] = None) -> np.ndarray:
        """Stage new nodes (+feature rows); returns their assigned ids,
        allocated contiguously above the current id space, so staged edges
        may reference them at once."""
        return self._staging_buffer().add_nodes(features, labels)

    def ingest_events(self, ev) -> int:
        """Stage one :class:`repro_torch.data.temporal.EventBatch` (nodes
        first, then the edges that may reference them)."""
        buf = self._staging_buffer()
        if ev.node_feats is not None and len(ev.node_feats):
            ids = buf.add_nodes(ev.node_feats, ev.node_labels)
            if int(ids[0]) != ev.node_base:
                raise ValueError(
                    "event batches must be ingested in stream order: new "
                    f"ids start at {int(ids[0])}, the batch at "
                    f"{ev.node_base}")
        return buf.add_edges(ev.src, ev.dst)

    def merge_deltas(self):
        """Force a merge NOW: synchronous refresh (drains the buffer at the
        build boundary) + adoption by the training sampler.  The serving
        path instead lets the fabric watchdog kick an ASYNC refresh when
        ``store.stream_merge_due()`` — same machinery, no pause."""
        if self.store is None:
            raise ValueError("merge_deltas needs the GNS feature store")
        gen = self.store.refresh(version=self.store.version + 1)
        self.sampler.adopt_generation()
        return gen

    # ------------------------------------------------------------------
    # checkpoints and the traffic record
    # ------------------------------------------------------------------
    def save(self, directory, step: int = 0, *, keep: int = 3):
        """Checkpoint the parameters, the optimizer state AND the un-merged
        delta log as ``step`` (:func:`repro_torch.checkpoint
        .save_checkpoint`; the reference's format, so either package
        restores it).  The stream buffer's seq-stamped ops ride the
        checkpoint's ``aux`` side-payload, so a crash between an ingest and
        the next merge loses nothing.  Returns its directory.

        On a mesh every rank calls it: the leader writes (the parameters
        and moments are the same on every rank) and every rank returns its
        directory, or raises its error, once it is written."""
        if self.mesh is None:
            return self._write_checkpoint(directory, step, keep)
        out = None
        if self.mesh.leader:
            try:
                out = self._write_checkpoint(directory, step, keep)
            except Exception as e:        # raised on every rank below
                out = e
        out = broadcast_object(out, self.mesh.host_group)
        if isinstance(out, Exception):
            raise out
        return out

    def _write_checkpoint(self, directory, step: int, keep: int):
        tree = {"params": self.params, "opt_state": self.opt_state}
        aux = {}
        extra: dict = {"seed": self.cfg.seed}
        if self._stream is not None:
            st = self._stream.state()
            extra["stream"] = {"next_node": int(st["next_node"]),
                               "next_seq": int(st["next_seq"])}
            aux = {f"stream/{k}": v for k, v in st.items()}
        return checkpoint.save_checkpoint(directory, step, tree, extra=extra,
                                          keep=keep, aux=aux)

    def restore(self, directory, step: Optional[int] = None) -> int:
        """Resume from :meth:`save` (the newest step when ``step`` is
        None): parameters and moments go back onto this engine's device.
        The staged delta log, when the checkpoint carries one, is re-staged
        into this engine's buffer with its original seqs (last-op-wins
        makes the replay idempotent).  Returns the restored step.  On a
        mesh every rank reads the same files; the leader re-stages the log
        and the other ranks take its id and seq clocks."""
        tree_like = {"params": self.params, "opt_state": self.opt_state}
        tree, step, _extra = checkpoint.load_checkpoint(
            directory, tree_like, step=step, device=self.device)
        self.params, self.opt_state = tree["params"], tree["opt_state"]
        aux = checkpoint.load_aux(directory, step)
        stream_state = {k.split("/", 1)[1]: v for k, v in aux.items()
                        if k.startswith("stream/")}
        if stream_state:
            if self.mesh is None or self.mesh.leader:
                self.stream.restore(stream_state)
            else:
                self.stream.follow(stream_state["next_node"],
                                   stream_state["next_seq"])
        return step

    def describe(self) -> dict:
        """The traffic record of this config: cache rows and table bytes,
        padded input rows and worst-case streamed bytes per batch, the
        sampler backend and the meter's breakdown (the reference's record
        without a mesh), on a mesh its shards, rows per shard and upload
        bytes per rank under ``"mesh"`` (:func:`~repro_torch.gns.describe
        .mesh_report`) and this rank's counted step under ``"lowering"``
        (:func:`~repro_torch.gns.describe.describe_lowering`, the
        reference's record on a mesh), and with streaming ingest attached its run state
        under ``"stream"``."""
        rec = traffic_report(
            num_nodes=self.ds.graph.num_nodes, feat_dim=self.ds.feat_dim,
            cache_frac=self.scfg.cache.fraction,
            batch=self.scfg.batch_size, fanouts=self.scfg.fanouts,
            n_shards=(self.store.n_shards if self.store else 1),
            meter=self.meter, backend=self.scfg.backend)
        if self.mesh is not None:
            rec["mesh"] = mesh_report(
                data=self.mesh.data, model=self.mesh.model,
                cache_rows=rec["cache_rows"], feat_dim=self.ds.feat_dim,
                n_groups=self.num_groups)
            rec["lowering"] = describe_lowering(
                mesh=self.mesh, num_nodes=self.ds.graph.num_nodes,
                feat_dim=self.ds.feat_dim, num_classes=self.ds.num_classes,
                cache_frac=self.scfg.cache.fraction,
                batch=self.scfg.batch_size * max(self.num_groups, 1),
                fanouts=tuple(self.scfg.fanouts),
                hidden_dim=self.mcfg.hidden_dim,
                input_impl=self.mcfg.input_impl, backend=self.scfg.backend,
                sample_kernel=self.mcfg.sample_kernel, optim=self.cfg.optim)
        if self._stream is not None and self.store is not None:
            # run-state fields: diff() drops "stream" as volatile, by name
            scfg = self.store.stream_cfg
            rec["stream"] = {
                "enabled": True,
                "max_pending": scfg.max_pending,
                "incremental_placement": scfg.incremental_placement,
                "pending_deltas": self.store.pending_deltas(),
                "merges_applied": self.store.merges_applied,
                "rows_migrated": self.store.rows_migrated,
            }
        return rec
