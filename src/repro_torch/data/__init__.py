"""Data substrate of the port: the synthetic token corpus and its
prefetched loader (the LM trainers), the hot-vocabulary embedding cache
(GNS's cache applied to LM tables), temporal event streams (the
serve-while-mutating ingest workload)."""
from repro_torch.data.temporal import (EventBatch, TemporalEventStream,
                                       temporal_event_stream)
from repro_torch.data.tokens import SyntheticCorpus, TokenPipeline
from repro_torch.data.vocab_cache import (VocabCache, VocabCacheConfig,
                                          embed_with_cache,
                                          sampled_softmax_loss)

__all__ = ["SyntheticCorpus", "TokenPipeline",
           "VocabCache", "VocabCacheConfig", "embed_with_cache",
           "sampled_softmax_loss",
           "EventBatch", "TemporalEventStream", "temporal_event_stream"]
