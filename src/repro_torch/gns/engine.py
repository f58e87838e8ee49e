"""GNSEngine (port of ``repro.gns.engine.GNSEngine``, one device).

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
* :meth:`describe`      — the traffic record of this config
  (:func:`repro_torch.gns.describe.traffic_report`);
* :meth:`save` / :meth:`restore` — parameters and optimizer state through
  :mod:`repro_torch.checkpoint`, in the reference's format.

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
CPU.  Meshes (DP > 1) and streaming ingest are not ported: the engine
refuses a config that asks for either.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core.minibatch import MiniBatch
from repro_torch.core.pipeline import EpochLoader, Prefetcher
from repro_torch.core.sampler import GNSSampler, make_sampler
from repro_torch.device import resolve_device
from repro_torch.featurestore import FeatureStore, TrafficMeter
from repro_torch.gns.config import EngineConfig
from repro_torch.gns.describe import traffic_report
from repro_torch.graph.datasets import get_dataset
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


class GNSEngine:
    """The wired pipeline for one :class:`EngineConfig`."""

    def __init__(self, cfg: EngineConfig, *, device=None, dataset=None,
                 model_cfg: Optional[graphsage.SageConfig] = None):
        """``device`` defaults to ``cuda``; ``dataset`` and ``model_cfg``
        override the declarative ``cfg.data`` and ``cfg.model`` with a
        built dataset and a :class:`graphsage.SageConfig` (as the
        reference's do; the ``GNNTrainer`` shim's path)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.mesh is not None and cfg.mesh.data * cfg.mesh.model > 1:
            raise NotImplementedError(
                f"mesh {cfg.mesh} needs the multi-device port; this engine "
                "runs on one device")
        if cfg.stream is not None:
            raise NotImplementedError(
                f"stream {cfg.stream} needs streaming ingest, not ported yet "
                "(ROADMAP.md Queue A item 5, streaming ingest); this engine "
                "would drop it")
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
                build_adjacency=True, seed=cfg.seed)
        else:
            self.store = None
        self.sampler = make_sampler(cfg.sampler, self.ds.graph, self.scfg,
                                    self.ds.features, self.ds.labels,
                                    train_idx=self.ds.train_idx,
                                    store=self.store)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.params = graphsage.init_params(self.mcfg, gen, self.device)
        self.opt = AdamW(cfg.optim)
        self.opt_state = self.opt.init(self.params)
        self._dummy_cache = graphsage.dummy_cache_table(self.ds.feat_dim,
                                                        self.device)
        # serving-shaped inference: one sampler per padded batch size
        # ("bucket"), all sharing THE store, so every bucket rides the same
        # live cache generation and feeds the same policy signals
        self._bucket_samplers: dict = {}

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

    def _put_batch(self, mb: MiniBatch, meter: TrafficMeter):
        """Host -> device copy of the batch, its wall time booked on
        ``meter`` (the copies are queued, not waited for, on a GPU)."""
        t0 = time.perf_counter()
        out = mb.device.to(self.device)
        meter.t_copy += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def run_batch(self, mb: MiniBatch) -> tuple[float, float]:
        """One optimizer step: forward, backward, AdamW.  Returns (loss,
        accuracy).  ``t_compute`` includes the sync that reading the loss
        forces, so it is the device time of the step plus its launches."""
        m = self.meter
        dev_batch = self._put_batch(mb, m)
        m.add_batch(mb.bytes_streamed)
        t0 = time.perf_counter()
        loss, acc, grads = graphsage.value_and_grad(
            self.params, dev_batch, self._cache_table(mb), self.mcfg,
            device_adj=self._device_adj(mb))
        self.params, self.opt_state = self.opt.update(grads, self.opt_state,
                                                      self.params)
        loss = loss.item()
        m.t_compute += time.perf_counter() - t0
        return loss, acc.item()

    def fit(self, epochs: int, max_batches: Optional[int] = None,
            prefetch: Optional[bool] = None,
            eval_every: Optional[int] = None,
            eval_batches: int = 8) -> TrainReport:
        """The §2.2 training loop; ``max_batches`` bounds steps per
        epoch."""
        if prefetch is None:
            prefetch = self.cfg.prefetch
        loader = EpochLoader(self.sampler, self.ds.train_idx, seed=self.seed,
                             max_batches=max_batches)
        report = TrainReport([], [], [], self.meter)
        n_inputs, n_cached, n_iso, n_b = 0, 0, 0, 0
        for ep in range(epochs):
            t_ep = time.perf_counter()
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
                with torch.inference_mode():
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
                      meter: Optional[TrafficMeter] = None) -> np.ndarray:
        """Run the forward on a prepared batch.

        Returns logits ``[bucket, classes]`` (padded rows included — slice
        the leading real rows off).  ``meter`` receives the host->device
        copy time (default: the engine's inference side meter).
        """
        dev_batch = self._put_batch(
            mb, meter if meter is not None else self.meter_infer)
        with torch.inference_mode():
            logits = graphsage.forward(self.params, dev_batch,
                                       self._cache_table(mb), self.mcfg,
                                       device_adj=self._device_adj(mb))
        return logits.cpu().numpy()

    def serve(self, serve_cfg=None):
        """A :class:`repro_torch.serve.GNSServer` over this engine (not
        started); the default config goes through
        :meth:`EngineConfig.serve_config`."""
        from repro_torch.serve import GNSServer
        return GNSServer(self, serve_cfg if serve_cfg is not None
                         else self.cfg.serve_config())

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
    # checkpoints and the traffic record
    # ------------------------------------------------------------------
    def save(self, directory, step: int = 0, *, keep: int = 3):
        """Checkpoint the parameters and the optimizer state as ``step``
        (:func:`repro_torch.checkpoint.save_checkpoint`; the reference's
        format, so either package restores it).  Returns its directory."""
        tree = {"params": self.params, "opt_state": self.opt_state}
        return checkpoint.save_checkpoint(directory, step, tree,
                                          extra={"seed": self.cfg.seed},
                                          keep=keep)

    def restore(self, directory, step: Optional[int] = None) -> int:
        """Resume from :meth:`save` (the newest step when ``step`` is
        None): parameters and moments go back onto this engine's device.
        Returns the restored step."""
        tree_like = {"params": self.params, "opt_state": self.opt_state}
        tree, step, _extra = checkpoint.load_checkpoint(
            directory, tree_like, step=step, device=self.device)
        self.params, self.opt_state = tree["params"], tree["opt_state"]
        return step

    def describe(self) -> dict:
        """The traffic record of this config: cache rows and table bytes,
        padded input rows and worst-case streamed bytes per batch, the
        sampler backend and the meter's breakdown (the reference's record
        without a mesh)."""
        return traffic_report(
            num_nodes=self.ds.graph.num_nodes, feat_dim=self.ds.feat_dim,
            cache_frac=self.scfg.cache.fraction,
            batch=self.scfg.batch_size, fanouts=self.scfg.fanouts,
            n_shards=(self.store.n_shards if self.store else 1),
            meter=self.meter, backend=self.scfg.backend)
