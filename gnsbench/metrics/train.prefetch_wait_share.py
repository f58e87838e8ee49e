"""Training loop (``gns/engine.py``, ``core/pipeline.py``): the share of
the window in which the step waited on the prefetch queue for its next
batch (``TrafficMeter.t_prefetch_wait``)."""
UNIT = "%"


def read(run):
    if not run.steps:
        return None
    return 100.0 * run.meter["t_prefetch_wait"] / run.window_s
