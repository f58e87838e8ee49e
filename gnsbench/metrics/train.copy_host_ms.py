"""Host-to-device copy (``core/minibatch.py`` ``DeviceBatch.to``): host
milliseconds a step spends queueing its batch's copies, pinned staging
included (``TrafficMeter.t_copy``)."""
UNIT = "ms"


def read(run):
    if not run.steps:
        return None
    return 1e3 * run.meter["t_copy"] / run.steps
