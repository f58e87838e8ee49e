"""Build, load and count the port's CUDA kernels.

The kernels live in ``repro_torch/csrc``: ``gather_agg.cu`` (K2),
``cache_lookup.cu`` (K1) and ``gns_sample_agg.cu`` (K3), on the row tiles
of ``tile_accum.cuh``, and K4's three routes, ``flash_attention_split.cu``
(split-KV decode), ``flash_attention_tc.cu`` (tensor cores, bf16) and
``flash_attention.cu`` (CUDA cores, f32).  They include only CUDA headers, and ``bindings.cpp`` is
the one small file that includes ``torch/extension.h``.  All of them go to
``torch.utils.cpp_extension.load`` in one call, for ``sm_90a`` (Hopper),
into ``build/repro_torch_kernels`` at the root of the checkout.  The build
happens at the first launch, never at import: a host without ``nvcc`` can
import every module and run the plain versions.
"""
from __future__ import annotations

import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("bindings.cpp", "gather_agg.cu", "cache_lookup.cu",
           "gns_sample_agg.cu", "flash_attention.cu",
           "flash_attention_split.cu", "flash_attention_tc.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_ext = None
_ext_lock = threading.Lock()


def load_kernels():
    """The compiled extension module, built on first use (thread-safe)."""
    global _ext
    with _ext_lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            _BUILD.mkdir(parents=True, exist_ok=True)
            _ext = load(name="repro_torch_kernels",
                        sources=[str(_CSRC / s) for s in SOURCES],
                        build_directory=str(_BUILD),
                        extra_cflags=["-O2"],
                        extra_cuda_cflags=list(CUDA_FLAGS))
        return _ext


class LaunchCounter:
    """Launches of one kernel: a plain integer behind a lock, so serving
    worker threads and a caller resetting it never lose an update."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
