"""``examples/serve_gns_torch.py``, the twin of ``examples/serve_gns.py``,
on the CPU at test size: the same lines as the reference's, the served /
submitted and micro-batch counts and the cache's hit rates included, but
the latencies; where the reference counts its compiled inference steps the
port counts the bucket shapes it served.

Both examples close a micro-batch on a 2 ms window of the host's clock,
so under load the 12 submits can straddle it in either package.  What the
window cannot change (the fitting and serving lines, 12/12 served) is held
on every run.  The micro-batch count, the fill, the bucket-shape count and
the ``cache:`` line (its hit rate, trajectory and swaps follow the
batches) are held once both runs formed the same micro-batches: one batch
of all 12 requests each, the only split the printed lines pin down.  The
pair is run again, at most ``ATTEMPTS`` times, until it does."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--requests", "12", "--scale", "0.02"]   # 12 requests: one batch
ATTEMPTS = 3
SERVED = re.compile(r"served (\d+)/(\d+) in (\d+) micro-batches "
                    r"\(fill (\d+)%, (compiled steps|bucket shapes "
                    r"served): (\d+)\)")


def _lines(script, extra=()) -> list:
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *ARGS, *extra],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                           JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def _run_pair() -> tuple:
    """Both examples once: (reference lines, port lines, reference
    ``served`` match, port ``served`` match), with every line that the
    batching window cannot change already held."""
    want = _lines("serve_gns.py")
    got = _lines("serve_gns_torch.py", ("--device", "cpu"))
    assert len(got) == len(want) == 5
    w, g = SERVED.fullmatch(want[2]), SERVED.fullmatch(got[2])
    assert w and g, (want[2], got[2])
    assert w.group(1, 2) == g.group(1, 2) == ("12", "12")
    assert w.group(5) == "compiled steps"
    assert g.group(5) == "bucket shapes served"
    for i in (0, 1):                # fitting, serving
        assert got[i] == want[i]
    assert got[3].startswith("latency: queue p50/p99 ")
    return want, got, w, g


def test_serve_twin_prints_the_reference_lines():
    batches = []
    for _ in range(ATTEMPTS):
        want, got, w, g = _run_pair()
        batches.append((w.group(3), g.group(3)))
        if batches[-1] == ("1", "1"):
            break
    else:
        pytest.fail(f"the two examples never both served the 12 requests "
                    f"in one micro-batch: (reference, port) micro-batches "
                    f"{batches}")
    assert w.group(6) == "1"
    assert g.group(4) == w.group(4)
    assert g.group(6) == "1"
    assert got[4] == want[4]        # cache; not latency
