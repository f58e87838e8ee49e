"""GNS core: §3.3 samplers (GNS and the paper's baselines NS, LADIES,
LazyGCN), §3.4 importance coefficients, padded blocks, §3.5 variance
probes (:mod:`repro_torch.core.variance`)."""
from repro_torch.core.importance import cache_hit_prob, importance_coefficients
from repro_torch.core.minibatch import DeviceBatch, LayerBlock, MiniBatch
from repro_torch.core.sampler import (GNSSampler, LadiesSampler,
                                      LazyGCNSampler, NeighborSampler,
                                      SamplerConfig, make_sampler)

__all__ = ["GNSSampler", "NeighborSampler", "LadiesSampler",
           "LazyGCNSampler", "SamplerConfig", "make_sampler",
           "cache_hit_prob", "importance_coefficients",
           "MiniBatch", "LayerBlock", "DeviceBatch"]
