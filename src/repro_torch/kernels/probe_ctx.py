"""Probe context: swap attention inners for HBM-traffic stand-ins (a copy
of ``repro.kernels.probe_ctx``).

The dry-run's memory term counts the bytes of every op the step runs, and
the reference attention's softmax chain materialises every [B,H,S,S]
intermediate.  On the card those live in shared memory inside the flash
kernel (``kernels/flash_attention.py``); counting them as HBM traffic
would overstate the memory term many times.

Under ``linear_attention_traffic()``, ``mha_ref`` computes a linear-cost
stand-in with the flash kernel's HBM footprint — q, k, v read once, out
written once — so the counted bytes match the kernelised execution.
FLOPs are taken from the un-switched pass (the kernel really does the S^2
matmuls); collectives are identical in both (attention is head-local).
Only multi-token attention is switched: a single-token decode step reads
its whole KV cache, and that traffic is real.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def linear_attention_on() -> bool:
    return getattr(_state, "linear", False)


@contextlib.contextmanager
def linear_attention_traffic(on: bool = True):
    prev = linear_attention_on()
    _state.linear = on
    try:
        yield
    finally:
        _state.linear = prev
