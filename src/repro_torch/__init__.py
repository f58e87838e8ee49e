"""PyTorch/CUDA port of the GNS reproduction (``repro``).

The package mirrors ``repro``'s module names, so each module's counterpart
is easy to find, and imports neither ``jax`` nor anything of ``repro``.
What is ported so far is the serving path and the training loop: host GNS
sampling, the device sampling backend, the feature store, 3-layer
GraphSAGE through the hand-written CUDA kernels ``cache_lookup_agg`` (K1,
layer 0), ``gather_agg`` (K2, upper layers) and ``gns_sample_agg`` (K3,
the device backend's layer 0), the repo's own AdamW, ``GNSEngine.fit`` /
``evaluate`` / ``infer`` and the ``GNSServer`` request loop.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``
(:mod:`repro_torch.device`).
"""
