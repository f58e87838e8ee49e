"""The port's dry-run (``launch/dryrun.py``, ``launch/specs.py``'s
``param_structs`` / ``input_specs``, ``launch/mesh.py::dryrun_mesh``,
``roofline/inspect.py``) against the reference's.

The reference's numbers come from ``tests/_dryrun_reference.py`` in a
subprocess (its dry-run module fixes jax's device count when imported).
For the six reduced families of ``tests/test_dryrun_small.py`` × (train,
decode, prefill) on a fake (2, 4) world:

* ``status: ok``; ``params_total`` / ``params_active`` equal the
  reference's ``_param_counts``; ``arg_bytes_per_device`` equals its
  ``_sharded_bytes`` on (2, 4) and (16, 16);
* the counted FLOPs on one device against the reference's
  ``cost_analysis`` of its unrolled step: the port counts only matmul-class
  ops (``torch.utils.flop_counter``), XLA counts elementwise work too, so
  the port's share is held to [``FLOP_SHARE``, 1] (measured 0.879 for
  zamba2, whose SSD is the most elementwise, to 0.994 for xlstm);
* the fake world logs the same collectives (op, bytes, group, site), and
  counts the same FLOPs, bytes and peak bytes, as a real gloo rank at the
  same mesh position running the same step on zeros.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import dryrun_mesh, run_ranks  # noqa: E402
from repro_torch.launch.sharding import arch_scope  # noqa: E402
from repro_torch.launch.specs import param_structs  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402
from repro_torch.models.scan_util import tree_leaves  # noqa: E402

ARCHS = ("qwen2-7b", "deepseek-v2-236b", "zamba2-2.7b", "xlstm-125m",
         "seamless-m4t-medium", "h2o-danube-3-4b")
KINDS = ("train", "decode", "prefill")
FLOP_SHARE = 0.85
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the gloo comparison: these ranks of (2, 2), these kinds
GLOO_RANKS, GLOO_KINDS = (0, 3), ("train", "decode")


def _shape(kind):
    from _torch_dryrun_ranks import SHAPES
    return SHAPES[kind]


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "tests/_dryrun_reference.py", "lm"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("REFERENCE_JSON ")][-1]
    return json.loads(line.split(" ", 1)[1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_records_on_a_fake_2x4_mesh(arch, kind, reference):
    cfg = configs.get_config(arch).reduced()
    rec = dryrun.run_cell(arch, _shape(kind), False, mesh_shape=(2, 4),
                          cfg=cfg)
    ref = reference[arch]
    assert rec["status"] == "ok" and rec["probe_mode"] == "executed"
    assert rec["mesh"] == "2x4" and rec["chips"] == 8
    assert (rec["params_total"], rec["params_active"]) == (
        ref["params_total"], ref["params_active"])
    assert rec["arg_bytes_per_device"] == ref[f"arg_{kind}_2x4"]
    with dryrun_mesh((16, 16)) as mesh, arch_scope(cfg):
        arg = dryrun.cell_step(cfg, _shape(kind), mesh, "float32")[1]
    assert arg == ref[f"arg_{kind}_16x16"]
    r = rec["roofline"]
    assert r["flops_per_chip"] == rec["cost_flops_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert rec["collectives"]["calls"] > 0 and rec["fits_hbm"]
    for key in ("lower_s", "compile_s", "hlo_bytes"):
        assert key not in rec
    assert rec["count_s"] >= 0


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_against_cost_analysis_on_one_device(arch, reference):
    cfg = configs.get_config(arch).reduced()
    rec = dryrun.run_cell(arch, _shape("train"), False, mesh_shape=(1, 1),
                          cfg=cfg)
    share = rec["cost_flops_per_device"] / reference[arch]["flops_train_1x1"]
    assert FLOP_SHARE <= share <= 1.0, share
    assert rec["collectives"]["calls"] == 0


@pytest.fixture(scope="module")
def gloo_counts():
    cells = [(a, k) for a in ARCHS for k in GLOO_KINDS]
    return run_ranks("_torch_dryrun_ranks:count_cells", data=2, model=2,
                     devices=["cpu"] * 4, backend="gloo", timeout_s=300.0,
                     args=(cells,))


@pytest.mark.parametrize("rank", GLOO_RANKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_fake_world_counts_as_a_real_gloo_rank(arch, rank, gloo_counts):
    cfg = configs.get_config(arch).reduced()
    for kind in GLOO_KINDS:
        with dryrun_mesh((2, 2), rank=rank) as mesh, arch_scope(cfg):
            run = dryrun.cell_step(cfg, _shape(kind), mesh, "float32")[0]
            counter, log = dryrun.count_step(run, mesh)
        flops, byt, peak, real_log = gloo_counts[rank][(arch, kind)]
        assert (counter.flops, counter.bytes, counter.peak_bytes) == (
            flops, byt, peak), kind
        assert [(r["op"], r["bytes"], r["group"], r["site"])
                for r in log] == real_log, kind


def test_param_structs_are_meta_at_published_widths():
    for arch in ("gemma-2b", "arctic-480b"):
        cfg = configs.get_config(arch)
        leaves = tree_leaves(param_structs(get_model(cfg)))
        assert {x.device.type for x in leaves} == {"meta"}
        from repro_torch.roofline.analysis import total_params
        assert sum(x.numel() for x in leaves) == pytest.approx(
            total_params(cfg), rel=0.02)


def test_skipped_cell_and_multipod_proof():
    rec = dryrun.run_cell("qwen2-7b", "long_500k", False)
    assert rec["status"] == "skipped" and rec["reason"]
    cfg = configs.get_config("qwen2-7b").reduced()
    rec = dryrun.run_cell("qwen2-7b", _shape("decode"), True,
                          mesh_shape=(2, 2, 2), cfg=cfg, probe=False)
    assert rec["status"] == "ok" and rec["mesh"] == "2x2x2"
    assert rec["probe_mode"] == "skipped(multipod)"
    assert rec["roofline"] is None and rec["arg_bytes_per_device"] > 0


def test_cli_writes_records_and_inspect_prints_sites(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k"]) == 0
    rec = json.loads((tmp_path / "xlstm-125m__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["roofline"]["chips"] == 256
    assert dryrun.main(["--arch", "xlstm-125m", "--shape",
                        "long_500k"]) == 0
    assert "[cached]" in capsys.readouterr().out
    from repro_torch.roofline import inspect
    inspect.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                  "--top", "3"])
    out = capsys.readouterr().out
    assert "-- by site --" in out and "models/" in out
    assert "memory census" in out
