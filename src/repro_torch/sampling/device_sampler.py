"""``backend="device"`` GNS sampler: the input layer is drawn on the device
(port of ``repro.sampling.device_sampler``).

:class:`DeviceGNSSampler` keeps the host
:class:`~repro_torch.core.sampler.GNSSampler` for the upper layers (top-up
sampling needs the full graph, which only the host holds) and stops
sampling the input layer on the host.  Per batch:

* the input block is a placeholder: ``pad_sizes[0]`` shrinks from
  ``(D0, D0·(1+k0))`` to ``(D0, D0)``, so the batch ships D0 input rows
  instead of D0·(1+k0);
* the layer-0 draw runs on the device (kernel K3 through
  :func:`repro_torch.sampling.kernels.gns_sample_agg`) against the
  generation's :class:`~repro_torch.sampling.adjacency.DeviceCacheAdj`,
  keyed by a per-batch 64-bit key (``DeviceBatch.sample_key``);
* destination rows the cache does not cover fall back to the host sampler:
  ``_sample_layer(allow_topup=False)`` draws their cached-neighbor lanes
  as the host backend would, and they ride along as
  ``input_fb_rows``/``input_fb_w`` (device-table rows and weights).

The weights are the host's, w = 1/(p^C_u·min(k, n_c)/n_c·deg v), with one
documented difference: rows with n_c > k draw with replacement on the
device where the host draws without.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.minibatch import LayerBlock, MiniBatch, make_block
from repro_torch.core.sampler import (GNSSampler, SamplerConfig, _assemble,
                                      _union_src)
from repro_torch.featurestore.store import FeatureStore
from repro_torch.graph.csr import CSRGraph


class DeviceGNSSampler(GNSSampler):
    """GNS with the input layer sampled on the device (module docstring)."""

    name = "gns"
    backend = "device"

    def __init__(self, graph: CSRGraph, cfg: SamplerConfig,
                 features: np.ndarray, labels: np.ndarray,
                 train_idx: Optional[np.ndarray] = None,
                 store: Optional[FeatureStore] = None, device=None):
        super().__init__(graph, cfg, features, labels, train_idx=train_idx,
                         store=store, device=device)
        # generations carry the device CSR from here on (set before the
        # first refresh builds one)
        self.store.build_device_adj = True
        d0 = self.pad_sizes[0][0]
        # the input block is a placeholder: src axis == dst axis (the device
        # draw replaces the host gather, so no neighbor lanes ship)
        self.pad_sizes = [(d0, d0)] + list(self.pad_sizes[1:])

    def sample(self, targets: np.ndarray,
               rng: np.random.Generator) -> MiniBatch:
        assert self.cache is not None, "call start_epoch/refresh_cache first"
        gen = self._gen
        assert gen.device_adj is not None, (
            "device backend needs generations built with build_device_adj")
        cfg = self.cfg
        ids = np.asarray(targets, dtype=np.int64)
        blocks: list[LayerBlock] = []
        for li in range(cfg.num_layers - 1, 0, -1):   # upper layers: host
            k = cfg.fanouts[li]
            nbrs, mask, w = self._sample_layer(ids, k, rng, allow_topup=True)
            src_ids, idx = _union_src(ids, nbrs, mask, self._stamp)
            pad_dst, pad_src = self.pad_sizes[li]
            blocks.append(make_block(idx, np.where(mask, w, 0.0),
                                     pad_dst, pad_src))
            ids = src_ids
        # placeholder input block: zero lanes and weights, dst == src rows
        d0 = self.pad_sizes[0][0]
        n0 = len(ids)
        blocks.append(make_block(np.zeros((n0, 1), dtype=np.int64),
                                 np.zeros((n0, 1)), d0, d0))
        mb = _assemble(blocks, ids, targets, self.features, self.labels,
                       self.pad_sizes, cfg.batch_size,
                       store=self.store, gen=gen)

        k0 = cfg.fanouts[0]
        slots = mb.device.input_cache_slots          # device rows, -1 = miss
        real = mb.device.input_mask > 0
        fb_rows = np.full((d0, k0), -1, dtype=np.int32)
        fb_w = np.zeros((d0, k0), dtype=np.float32)
        fb = (slots < 0) & real                      # uncached real dst rows
        if fb.any():
            fb_ids = mb.input_node_ids[fb]
            nbrs, mask, w = self._sample_layer(fb_ids, k0, rng,
                                               allow_topup=False)
            state = gen.state
            rows = state.device_rows(state.slot_of[nbrs]).astype(np.int32)
            fb_rows[fb] = np.where(mask, rows, -1)
            fb_w[fb] = np.where(mask, w, 0.0).astype(np.float32)

        key = rng.integers(0, 2 ** 32, size=(1, 2), dtype=np.uint32)

        # isolated = real dst rows that the device draw AND the fallback
        # both leave without a lane (the host backend's Table-5 counter)
        nc = (gen.cache_adj.indptr[mb.input_node_ids + 1]
              - gen.cache_adj.indptr[mb.input_node_ids])
        covered = np.where(slots >= 0, nc > 0, (fb_w > 0).any(axis=1))
        iso = int((real & ~covered).sum())

        dev = dataclasses.replace(mb.device, input_fb_rows=fb_rows,
                                  input_fb_w=fb_w, sample_key=key)
        return dataclasses.replace(mb, device=dev, num_isolated=iso)
