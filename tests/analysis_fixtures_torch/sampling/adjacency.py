"""Fixture: a pad-registry violation (never imported — parsed only).

``build_device_cache_adj`` lost the power-of-two rounding of its capacity,
so every refresh would give the device CSR a new shape.
"""


def build_device_cache_adj(state, host_adj, degrees, lam=None, meter=None,
                           device=None):
    nnz = int(host_adj.indptr[-1])
    cap = max(1024, nnz)             # retrace-pad-registry: not rounded up
    return cap
