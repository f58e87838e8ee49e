"""Device-resident GNS sampling (port of ``repro.sampling``).

* :mod:`~repro_torch.sampling.rng` — the counter-based stateless RNG
  (fmix32 chain), in int64 arithmetic that gives the reference's uint32 bits.
* :mod:`~repro_torch.sampling.adjacency` — each generation's cached-neighbor
  CSR over device-table rows, uploaded with the table.
* :mod:`~repro_torch.sampling.ref` — the plain slot gather-aggregate.
* :mod:`~repro_torch.sampling.kernels` — the layer-0 draw, the fallback
  merge and the gather: the plain version on the CPU, kernel K3
  (``csrc/gns_sample_agg.cu``) on the card.
* :mod:`~repro_torch.sampling.device_sampler` — the ``backend="device"``
  sampler that ``core.sampler.make_sampler`` builds.

This ``__init__`` imports none of them: they import ``core``, whose
sampler builds the device sampler and whose feature store builds the
device CSR, each on demand.
"""
