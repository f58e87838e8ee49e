"""GraphSAGE step (``models/graphsage.py``, ``optim/adam.py``): device
milliseconds a step, the union of every device operation in the traced
window over the window's steps."""
UNIT = "ms"


def read(run):
    if run.trace is None or not run.steps or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.busy_s / run.steps
