"""GNSEngine — the serving half of ``repro.gns.engine.GNSEngine``.

One object owns the wiring

    FeatureStore  →  sampler  →  GraphSAGE forward (CUDA kernels)

built from one declarative :class:`~repro_torch.gns.config.EngineConfig`
(the reference's JSON loads unchanged), and exposes the serving verbs:

* :meth:`infer`         — mini-batch inference reusing the LIVE cache
  generation: logits for arbitrary node ids, no refresh beyond the cold
  start, no accounting;
* :meth:`infer_prepare` / :meth:`infer_compute` — the two halves
  :class:`~repro_torch.serve.GNSServer` drives per micro-batch;
* :meth:`serve`         — a :class:`~repro_torch.serve.GNSServer` over
  this engine.

The reference's jit'd logits step is an eager forward under
``torch.inference_mode()``.  The engine runs on ``cuda`` unless the caller
passes ``device="cpu"``; without a GPU and without ``device=`` it raises
rather than run on the CPU.  ``fit``/``evaluate`` (training, with the
kernels' backward passes), ``describe``, meshes and streaming ingest are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.minibatch import MiniBatch
from repro_torch.core.sampler import GNSSampler, make_sampler
from repro_torch.featurestore import FeatureStore, TrafficMeter
from repro_torch.gns.config import EngineConfig
from repro_torch.graph.datasets import get_dataset
from repro_torch.models import graphsage


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


class GNSEngine:
    """The wired serving pipeline for one :class:`EngineConfig`."""

    def __init__(self, cfg: EngineConfig, *, device=None):
        """``device`` defaults to ``cuda``."""
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.mesh is not None and cfg.mesh.data * cfg.mesh.model > 1:
            raise NotImplementedError(
                f"mesh {cfg.mesh} needs the multi-device port; this engine "
                "runs on one device")
        self.ds = get_dataset(cfg.data.name, scale=cfg.data.scale,
                              seed=cfg.data.seed)
        self.scfg = cfg.sampler_config()
        m = cfg.model
        self.mcfg = graphsage.SageConfig(
            feat_dim=self.ds.feat_dim, hidden_dim=m.hidden_dim,
            num_classes=self.ds.num_classes,
            num_layers=len(self.scfg.fanouts),
            aggregate_impl=m.aggregate_impl, input_impl=m.input_impl)
        self.meter = TrafficMeter()
        # one-shot inference books its copy time here, never on the
        # training meter
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

    def _put_batch(self, mb: MiniBatch, meter: TrafficMeter):
        """Host -> device copy of the batch, its wall time booked on
        ``meter`` (the copies are queued, not waited for, on a GPU)."""
        t0 = time.perf_counter()
        out = mb.device.to(self.device)
        meter.t_copy += time.perf_counter() - t0
        return out

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
                                       self._cache_table(mb), self.mcfg)
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
