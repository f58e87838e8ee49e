"""The GNS engine's dry-run (``gns/describe.py::describe_lowering``,
``launch/dryrun_gnn.py``, ``gns/engine.py::make_train_step``) against the
reference's.

On fake (2, 2) and (1, 4) worlds, for each fast path, the record's
cache rows, bytes per chip, upload bytes, data-parallel groups, input
rows, placement fields and cross-shard bytes equal the reference's
``describe_lowering`` record of the same dimensions (computed in a
subprocess, ``tests/_dryrun_reference.py gnn``); its counted step runs
and logs the layer-0 collectives.  ``dryrun_gnn --diff`` has the
reference's exit status, and ``GNSEngine.describe()`` on a mesh of gloo
ranks carries the lowering record.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun_gnn  # noqa: E402
from repro_torch.launch.mesh import dryrun_mesh, run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GNN = dict(num_nodes=5000, feat_dim=32, num_classes=8, cache_frac=0.05,
           batch=16, fanouts=(3, 4), hidden_dim=16, input_impl="fused")
SAME = ("arch", "shape", "mesh", "chips", "status", "kind",
        "sampler_backend", "input_rows_per_batch", "input_impl",
        "cache_shard_axis", "dp_groups", "fast_path", "local_fast_path",
        "params_total", "cache_rows", "cache_bytes_per_chip",
        "upload_bytes_per_gen_sharded", "upload_bytes_per_gen_replicated",
        "lookup_local_frac_contiguous", "lookup_local_frac_locality",
        "crossshard_rows_frac_contiguous", "crossshard_rows_frac_locality",
        "crossshard_bytes_per_batch_contiguous",
        "crossshard_bytes_per_batch_locality")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "tests/_dryrun_reference.py", "gnn"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("REFERENCE_JSON ")][-1]
    return json.loads(line.split(" ", 1)[1])


@pytest.mark.parametrize("fast", ["dynamic", "static", "off"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_describe_lowering_matches_the_reference(shape, fast, reference):
    with dryrun_mesh(shape) as mesh:
        rec = dryrun_gnn.run(mesh=mesh, fast_path=fast, **GNN)
    want = reference[f"{shape[0]}x{shape[1]}_{fast}"]
    for key in SAME:
        assert rec[key] == want[key], key
    assert rec["count_s"] >= 0 and "compile_s" not in rec
    coll = rec["roofline"]["collective_detail"]
    # the step's broadcast of its group's shard-0 sums over the cache
    # axis, and on the static path the owner's broadcast of layer 0's rows
    assert coll["total"] > 0
    assert coll["broadcast"]["count"] == (2 if fast == "static" else 1)
    assert rec["cost_flops_per_device"] > 0


def test_production_meshes_count_the_papers100m_step():
    rec = dryrun_gnn.run()
    assert rec["mesh"] == "16x16" and rec["dp_groups"] == 16
    assert rec["cache_rows"] % 16 == 0 and rec["roofline"]["chips"] == 256
    multi = dryrun_gnn.run(multi_pod=True)
    assert multi["mesh"] == "2x16x16" and multi["dp_groups"] == 32


@pytest.mark.parametrize("pair", [("quickstart", "quickstart"),
                                  ("quickstart", "bench_ci")])
def test_diff_exit_status_matches_the_reference(pair, reference, capsys):
    want = reference["diff_same" if pair[0] == pair[1] else "diff_other"]
    assert dryrun_gnn.main_diff(*pair, device="cpu") == want
    assert json.loads(capsys.readouterr().out)["same"] == (want == 0)


def test_engine_describe_on_a_mesh_carries_the_lowering():
    recs = run_ranks("_torch_dryrun_ranks:describe_engine", data=1,
                     model=2, devices=["cpu"] * 2, backend="gloo",
                     timeout_s=300.0)
    for rec in recs:
        low = rec["lowering"]
        assert low["mesh"] == "1x2" and low["dp_groups"] == 1
        assert low["cache_rows"] == rec["cache_rows"]
        assert low["status"] == "ok" and low["cost_flops_per_device"] > 0
