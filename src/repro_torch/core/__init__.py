"""GNS core: §3.3 samplers, §3.4 importance coefficients, padded blocks."""
from repro_torch.core.importance import cache_hit_prob, importance_coefficients
from repro_torch.core.minibatch import DeviceBatch, LayerBlock, MiniBatch
from repro_torch.core.sampler import (GNSSampler, NeighborSampler,
                                      SamplerConfig, make_sampler)

__all__ = ["GNSSampler", "NeighborSampler", "SamplerConfig", "make_sampler",
           "cache_hit_prob", "importance_coefficients",
           "MiniBatch", "LayerBlock", "DeviceBatch"]
