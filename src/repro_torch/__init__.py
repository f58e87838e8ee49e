"""PyTorch/CUDA port of the GNS reproduction (``repro``).

The package mirrors ``repro``'s module names, so each module's counterpart
is easy to find, and imports neither ``jax`` nor anything of ``repro``.
What is ported so far is the serving path: host GNS sampling, the feature
store, 3-layer GraphSAGE inference through the hand-written CUDA kernels
``cache_lookup_agg`` (layer 0) and ``gather_agg`` (upper layers), and the
``GNSServer`` request loop.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
