"""Plain PyTorch versions of every ported kernel, under the names of
``repro/kernels/ref.py`` (the oracles the tests hold the kernels to).

Each plain version lives beside its kernel's wrapper; this module only
collects them.
"""
from repro_torch.kernels.cache_lookup import (
    cache_lookup_agg_plain as cache_lookup_agg_ref)
from repro_torch.kernels.gather_agg import gather_agg_plain as gather_agg_ref

__all__ = ["gather_agg_ref", "cache_lookup_agg_ref"]
