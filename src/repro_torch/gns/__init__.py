"""GNS engine: one declarative config, the serving surface.

* :class:`EngineConfig` (+ sub-configs and the ``preset`` registry) — the
  reference's declarative description of a run; its JSON loads unchanged.
* :class:`GNSEngine` — FeatureStore → sampler → GraphSAGE forward, with
  ``infer`` / ``infer_prepare`` / ``infer_compute`` / ``serve``.
"""
from repro_torch.gns.config import (PRESETS, DataConfig, EngineConfig,
                                    FabricConfig, MeshConfig, ModelConfig,
                                    ServeConfig, StreamConfig, TenantConfig)
from repro_torch.gns.engine import GNSEngine

__all__ = [
    "EngineConfig", "DataConfig", "MeshConfig", "ModelConfig", "ServeConfig",
    "FabricConfig", "StreamConfig", "TenantConfig", "PRESETS", "GNSEngine",
]
