"""Streaming graph ingest: delta-CSR updates under live serving and
training (port of ``repro.stream``).

Graphs mutate while the server answers queries.  This package applies
edge/node deltas to the live structure WITHOUT pausing anything, by riding
the generation machinery of the feature store:

* :class:`DeltaBuffer` — thread-safe, bounded (``QueueFull``), seq-stamped
  staging log producers append to at any time (``engine.ingest()``);
* :func:`merge_delta_csr` — deterministic delta-CSR merge, bitwise equal to
  a from-scratch rebuild and to the reference's merge, applied by
  ``FeatureStore._build`` at the next generation boundary — the atomic swap
  then publishes structure + features together, while in-flight batches
  stay pinned to the pre-merge generation;
* :class:`StreamConfig` (re-exported from ``repro_torch.gns.config``) — the
  declarative knob block nested under ``EngineConfig.stream``.

The temporal-event replay lives in ``repro_torch.data.temporal``.
"""
from repro_torch.gns.config import StreamConfig
from repro_torch.stream.delta import DeltaBatch, DeltaBuffer
from repro_torch.stream.merge import merge_delta_csr

__all__ = ["DeltaBatch", "DeltaBuffer", "StreamConfig", "merge_delta_csr"]
