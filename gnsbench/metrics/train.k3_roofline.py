"""Kernels (``csrc/gns_sample_agg.cu`` via ``sampling/kernels.py``): K3's
share of its roofline, its bound a launch (``gnsbench.flops.sample_work``
and ``bound_ms`` of the window's first steps' layer-0 draws, against the
window's own cache generation) times its launches in the traced window,
over its device time there."""
UNIT = "%"
KERNEL = "gns_sample_agg_kernel"


def read(run):
    if run.trace is None or run.k3_bound_ms is None:
        return None
    seconds, launches = run.trace.kernel(KERNEL)
    if not launches or seconds <= 0:
        return None
    return 100.0 * run.k3_bound_ms * 1e-3 * launches / seconds
