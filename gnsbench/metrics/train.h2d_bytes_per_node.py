"""Host-to-device copy (``core/minibatch.py``, ``featurestore/store.py``):
the bytes the meter books as crossing to the device (streamed feature
rows, cache table and cache CSR uploads) over the window, per trained
node."""
UNIT = "B/node"


def read(run):
    if not run.nodes:
        return None
    m = run.meter
    return (m["bytes_streamed"] + m["bytes_cache_upload"]
            + m["bytes_adj_upload"]) / run.nodes
