"""Feature store and cache (``featurestore/store.py``): the share of
layer-0 input rows (the rows whose own features layer 0 reads, and from
whose cached neighbours the device draws) that the device cache served,
from the meter's device tier (``TrafficMeter.tier("device")``)."""
UNIT = "%"


def read(run):
    hits, misses = run.meter["device_hits"], run.meter["device_misses"]
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
