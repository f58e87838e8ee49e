"""Host sampler (``core/sampler.py``): milliseconds of one sampler call
for one batch, from the benchmark's own span around it inside the
prefetch thread, averaged over the calls that ran in the window."""
UNIT = "ms"


def read(run):
    if not run.sample_ms:
        return None
    return sum(run.sample_ms) / len(run.sample_ms)
