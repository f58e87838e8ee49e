"""Counter-based stateless RNG of the device sampler (port of
``repro.sampling.rng``).

The draw for destination row ``r`` of a batch sampled with key
``(lo, hi)`` depends only on ``(lo, hi, r, lane)``: re-running a batch
reproduces its sample bit for bit.  The generator is murmur3's 32-bit
finalizer (fmix32) chained over the key and counter words.

PyTorch on the CPU has no ``>>`` or ``%`` for ``uint32``, so the plain
version computes in ``int64`` on values in ``[0, 2**32)``: shifts and xors
are exact there, and each product keeps its low 32 bits after
``& 0xFFFFFFFF`` (int64 multiplication wraps, and wrapping leaves the low
bits alone).  The result equals the reference's uint32 bits.  Kernel K3
(``csrc/gns_sample_agg.cu``) computes the same chain in native ``uint32``.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def murmur_fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK32
    x = x ^ (x >> 16)
    return x


def mix32(*words) -> torch.Tensor:
    """Hash int64 tensors (or ints) of uint32 values, broadcast together, to
    int64 tensors of uint32 bits: ``mix32(key_lo, key_hi, row, lane)``."""
    ref = next(w for w in words if isinstance(w, torch.Tensor))
    h = torch.full((), GOLDEN, dtype=torch.int64, device=ref.device)
    for w in words:
        if isinstance(w, torch.Tensor):
            w = w.to(torch.int64) & MASK32
        else:
            w = int(w) & MASK32
        h = murmur_fmix(h ^ w)
    return h
