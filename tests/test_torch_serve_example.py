"""``examples/serve_gns_torch.py``, the twin of ``examples/serve_gns.py``,
on the CPU at test size: the same lines as the reference's, the served /
submitted and micro-batch counts and the cache's hit rates included, but
the latencies; where the reference counts its compiled inference steps the
port counts the bucket shapes it served."""
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


def _lines(script, extra=()) -> list:
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *ARGS, *extra],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                           JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_serve_twin_prints_the_reference_lines():
    want = _lines("serve_gns.py")
    got = _lines("serve_gns_torch.py", ("--device", "cpu"))
    assert len(got) == len(want) == 5
    served = re.compile(r"served (\d+)/(\d+) in (\d+) micro-batches "
                        r"\(fill (\d+)%, (compiled steps|bucket shapes "
                        r"served): (\d+)\)")
    w, g = served.fullmatch(want[2]), served.fullmatch(got[2])
    assert w and g, (want[2], got[2])
    assert w.group(5, 6) == ("compiled steps", "1")
    assert w.group(1, 2, 3) == ("12", "12", "1")
    assert g.group(1, 2, 3, 4) == w.group(1, 2, 3, 4)
    assert g.group(5, 6) == ("bucket shapes served", "1")
    for i in (0, 1, 4):             # fitting, serving, cache; not latency
        assert got[i] == want[i]
    assert got[3].startswith("latency: queue p50/p99 ")
