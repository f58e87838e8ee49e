"""GNN trainer — thin compatibility shim over
:class:`repro_torch.gns.GNSEngine` (port of ``repro.train.trainer``).

The paper's mixed CPU-GPU training loop (§2.2) lives in the engine: one
declarative :class:`~repro_torch.gns.EngineConfig` drives the FeatureStore
→ sampler → EpochLoader/Prefetcher → step wiring.  ``GNNTrainer`` keeps the
historical constructor/``train``/``evaluate`` surface by building the
equivalent ``EngineConfig`` and delegating; its state (``params`` /
``opt_state`` / ``meter`` / ``store`` / ``sampler``) aliases the engine's,
so trainer-driven and engine-driven runs are the same run.  New code
should use the engine directly.

The engine runs on ``device`` (``None``: the GPU); ``mesh`` (a
:class:`~repro_torch.launch.mesh.HostMesh`, one process per mesh position)
and ``cache_shard_axis`` pass through to it, as the reference's do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.sampler import SamplerConfig
from repro_torch.gns.config import EngineConfig
from repro_torch.gns.engine import GNSEngine, TrainReport
from repro_torch.graph.datasets import GraphDataset
from repro_torch.models import graphsage
from repro_torch.optim.adam import AdamConfig

__all__ = ["GNNTrainer", "TrainReport"]


class GNNTrainer:
    """Shim: the historical kwarg surface, engine underneath."""

    def __init__(self, ds: GraphDataset, sampler_name: str,
                 sampler_cfg: Optional[SamplerConfig] = None,
                 model_cfg: Optional[graphsage.SageConfig] = None,
                 adam_cfg: Optional[AdamConfig] = None,
                 mesh=None, cache_shard_axis: Optional[str] = None,
                 seed: int = 0, device=None):
        scfg = sampler_cfg or SamplerConfig(batch_size=256)
        cfg = EngineConfig(sampler=sampler_name, sampling=scfg,
                           cache=scfg.cache,
                           optim=adam_cfg or AdamConfig(lr=3e-3),
                           seed=seed)
        self.engine = GNSEngine(cfg, device=device, dataset=ds,
                                model_cfg=model_cfg, mesh=mesh,
                                cache_shard_axis=cache_shard_axis)
        self.sampler_name = sampler_name

    # -- state aliases (read/write flows through to the engine) ------------
    @property
    def ds(self):
        return self.engine.ds

    @property
    def device(self):
        return self.engine.device

    @property
    def scfg(self):
        return self.engine.scfg

    @property
    def mcfg(self):
        return self.engine.mcfg

    @property
    def meter(self):
        return self.engine.meter

    @property
    def store(self):
        return self.engine.store

    @property
    def mesh(self):
        return self.engine.mesh

    @property
    def sampler(self):
        return self.engine.sampler

    @property
    def opt(self):
        return self.engine.opt

    @property
    def seed(self):
        return self.engine.seed

    @property
    def params(self):
        return self.engine.params

    @params.setter
    def params(self, v):
        self.engine.params = v

    @property
    def opt_state(self):
        return self.engine.opt_state

    @opt_state.setter
    def opt_state(self, v):
        self.engine.opt_state = v

    # -- the historical verbs ---------------------------------------------
    def run_batch(self, mb) -> tuple[float, float]:
        return self.engine.run_batch(mb)

    def train(self, epochs: int, max_batches: Optional[int] = None,
              prefetch: bool = False, eval_every: Optional[int] = None,
              eval_batches: int = 8) -> TrainReport:
        return self.engine.fit(epochs, max_batches=max_batches,
                               prefetch=prefetch, eval_every=eval_every,
                               eval_batches=eval_batches)

    def evaluate(self, idx: np.ndarray, num_batches: int = 8) -> float:
        return self.engine.evaluate(idx, num_batches=num_batches)
