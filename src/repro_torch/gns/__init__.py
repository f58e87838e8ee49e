"""GNS engine: one declarative config, training and serving.

* :class:`EngineConfig` (+ sub-configs and the ``preset`` registry) — the
  reference's declarative description of a run; its JSON loads unchanged.
* :class:`GNSEngine` — FeatureStore → sampler → GraphSAGE, with ``fit`` /
  ``evaluate`` / ``infer`` / ``infer_prepare`` / ``infer_compute`` /
  ``serve`` / ``describe`` / ``save`` / ``restore``.
* :class:`TrainReport` — fit() result (timings, losses, traffic meter).
"""
from repro_torch.gns.config import (PRESETS, DataConfig, EngineConfig,
                                    FabricConfig, MeshConfig, ModelConfig,
                                    ServeConfig, StreamConfig, TenantConfig)
from repro_torch.gns.engine import GNSEngine, TrainReport

__all__ = [
    "EngineConfig", "DataConfig", "MeshConfig", "ModelConfig", "ServeConfig",
    "FabricConfig", "StreamConfig", "TenantConfig", "PRESETS", "GNSEngine",
    "TrainReport",
]
