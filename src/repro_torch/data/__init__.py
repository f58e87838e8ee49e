"""Data substrate of the port: the synthetic token corpus and its
prefetched loader (the LM trainers), temporal event streams (the
serve-while-mutating ingest workload).  The reference's vocabulary cache
(``repro.data.vocab_cache``) is not ported yet (``ROADMAP.md`` Queue A item
9.5)."""
from repro_torch.data.temporal import (EventBatch, TemporalEventStream,
                                       temporal_event_stream)
from repro_torch.data.tokens import SyntheticCorpus, TokenPipeline

__all__ = ["SyntheticCorpus", "TokenPipeline",
           "EventBatch", "TemporalEventStream", "temporal_event_stream"]
