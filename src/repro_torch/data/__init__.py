"""Data substrate of the port: temporal event streams (the
serve-while-mutating ingest workload).  The reference's token corpus and
vocabulary cache (``repro.data.tokens``, ``repro.data.vocab_cache``) are
not ported yet."""
from repro_torch.data.temporal import (EventBatch, TemporalEventStream,
                                       temporal_event_stream)

__all__ = ["EventBatch", "TemporalEventStream", "temporal_event_stream"]
