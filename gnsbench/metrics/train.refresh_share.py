"""Feature store and cache (``featurestore/store.py``, ``policies.py``):
the share of the window spent building cache generations
(``TrafficMeter.t_refresh``)."""
UNIT = "%"


def read(run):
    if not run.steps:
        return None
    return 100.0 * run.meter["t_refresh"] / run.window_s
