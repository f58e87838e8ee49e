"""The yardstick's arithmetic: the H100's peaks, a kernel's bound, the work
of kernel K3 and the model FLOPs of a GraphSAGE step.

``bound_ms`` and ``sample_work`` are frozen copies of ``chip_smoke.py``'s
(the same formulas, taking counts where those take tensors).  Peaks are
NVIDIA's data sheet for the H100 SXM, dense, at the full 700 W power
limit; the program keeps TF32 off, so its float32 step runs outside the
tensor cores and its peak is 67 TFLOP/s.
"""
from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS = 67e12                # H100 SXM float32 outside the tensor cores


def bound_ms(n_bytes: int, n_flops: int,
             flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and operations over
    ``flops_per_s``, in ms, and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sample_work(bsz: int, k: int, uncached_dst: int, csr_rows: int,
                nnz: int, distinct_rows: int, live_lanes: int, d: int,
                elt: int = 4) -> tuple[int, int]:
    """Bytes and flops K3 needs: ``dst_rows`` once (4 B a row), the
    fallback lanes of the uncached rows once (8 B a lane), the CSR's four
    arrays once (``indptr`` and ``indices`` 4 B an entry, ``deg`` and
    ``hitp`` 8 B a row together), each distinct table row a live lane
    reads once, the [bsz, d] float32 output once; two flops per element
    of a live lane."""
    n_bytes = (bsz * 4 + uncached_dst * k * 8 + (csr_rows + 1 + nnz) * 4
               + csr_rows * 8 + distinct_rows * d * elt + bsz * d * 4)
    return n_bytes, 2 * live_lanes * d


def sage_step_flops(dst_rows: Sequence[int], fanouts: Sequence[int],
                    dims: Sequence[int]) -> int:
    """Model FLOPs of one GraphSAGE training step, from the real
    destination rows of each block (input-first), the fanouts and the
    widths ``dims`` (``feat, hidden, ..., classes``).

    Layer l with n rows, fanout k, width f_in -> f_out: the aggregate
    2·n·k·f_in, the concat product 2·n·(2·f_in)·f_out.  The backward
    takes the weight gradient (one product) everywhere and, above layer
    0, the input gradient (a second product) and the aggregate's own
    (one more aggregate); layer 0's inputs and its aggregate take no
    gradient.  The optimizer and the loss are left out."""
    total = 0
    for i, (n, k) in enumerate(zip(dst_rows, fanouts)):
        f_in, f_out = dims[i], dims[i + 1]
        agg = 2 * n * k * f_in
        mm = 2 * n * 2 * f_in * f_out
        total += agg + 2 * mm if i == 0 else 2 * agg + 3 * mm
    return total
