"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

* K1 ``cache_lookup`` — fused cache lookup + layer-0 gather-aggregate
  (replaces ``repro/kernels/cache_lookup.py::cache_lookup_agg_pallas``);
* K2 ``gather_agg`` — weighted gather-aggregate of the upper layers
  (replaces ``repro/kernels/gather_agg.py::gather_agg_pallas``).

``ops`` dispatches by device; ``ref`` collects the plain versions.
Importing this package builds nothing: the CUDA sources compile at the
first launch.
"""
