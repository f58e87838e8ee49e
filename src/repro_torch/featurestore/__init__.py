"""Multi-tier feature store: device cache -> staging -> host features.

Public surface as in ``repro.featurestore``: :class:`FeatureStore`, the
cache policy registry, :class:`TrafficMeter`, the §3.2 cache sampling and
the locality placement solver.
"""
from repro_torch.featurestore.meter import TierStats, TrafficMeter
from repro_torch.featurestore.placement import (PlacementMap, RoutingTable,
                                                home_shard,
                                                identity_placement,
                                                routing_table_from_state,
                                                solve_placement)
from repro_torch.featurestore.policies import (POLICIES, CachePolicy,
                                               degree_cache_probs,
                                               make_policy,
                                               random_walk_cache_probs,
                                               register_policy,
                                               reverse_pagerank_cache_probs,
                                               uniform_cache_probs)
from repro_torch.featurestore.store import (CacheConfig, CacheState,
                                            FeatureStore, Generation,
                                            cache_probs, sample_cache)

__all__ = [
    "FeatureStore", "Generation", "CacheConfig", "CacheState",
    "cache_probs", "sample_cache",
    "CachePolicy", "POLICIES", "make_policy", "register_policy",
    "degree_cache_probs", "random_walk_cache_probs",
    "reverse_pagerank_cache_probs", "uniform_cache_probs",
    "TrafficMeter", "TierStats",
    "PlacementMap", "home_shard", "identity_placement", "solve_placement",
    "RoutingTable", "routing_table_from_state",
]
