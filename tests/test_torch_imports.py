"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or anything of ``repro``; and the smoke
script refuses to run without a CUDA card or without the package.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]

# every module of the port's serving, training, LM serving, training-
# surface (baselines, checkpoints, describe, schedules, trainer), fabric /
# streaming-ingest (with the runtime lock sanitizer), RPC, mesh, static
# analysis, LM training, recurrent LM, LM-on-a-mesh and vocabulary-cache
# slices, and the dry-run / roofline slice
REQUIRED = (
    "repro_torch.device", "repro_torch.core.pipeline",
    "repro_torch.sampling.rng", "repro_torch.sampling.adjacency",
    "repro_torch.sampling.ref", "repro_torch.sampling.kernels",
    "repro_torch.sampling.device_sampler", "repro_torch.optim.adam",
    "repro_torch.kernels.ops", "repro_torch.gns.engine",
    "repro_torch.models.graphsage", "repro_torch.featurestore.store",
    "repro_torch.configs", "repro_torch.configs.seamless_m4t_medium",
    "repro_torch.kernels.ref", "repro_torch.kernels.flash_attention",
    "repro_torch.models.common", "repro_torch.models.scan_util",
    "repro_torch.models.ffn", "repro_torch.models.attention",
    "repro_torch.models.transformer", "repro_torch.models.encdec",
    "repro_torch.models.lm", "repro_torch.models.lm_params",
    "repro_torch.launch.serve", "repro_torch.core.sampler",
    "repro_torch.core.variance", "repro_torch.optim.schedules",
    "repro_torch.gns.describe", "repro_torch.checkpoint",
    "repro_torch.checkpoint.store", "repro_torch.train",
    "repro_torch.train.trainer", "repro_torch.analysis",
    "repro_torch.analysis.runtime", "repro_torch.serve.tenancy",
    "repro_torch.serve.router", "repro_torch.serve.fabric",
    "repro_torch.stream", "repro_torch.stream.delta",
    "repro_torch.stream.merge", "repro_torch.data",
    "repro_torch.data.temporal", "repro_torch.rpc", "repro_torch.rpc.wire",
    "repro_torch.rpc.channel", "repro_torch.rpc.proxy",
    "repro_torch.rpc.endpoint", "repro_torch.graph.partition",
    "repro_torch.launch.mesh", "repro_torch.launch.sharding",
    "repro_torch.analysis.common", "repro_torch.analysis.baseline",
    "repro_torch.analysis.locks", "repro_torch.analysis.generation",
    "repro_torch.analysis.meterlint", "repro_torch.analysis.retrace",
    "repro_torch.analysis.__main__", "repro_torch.launch.steps",
    "repro_torch.launch.train", "repro_torch.data.tokens",
    "repro_torch.models.ssm", "repro_torch.models.hybrid",
    "repro_torch.models.xlstm", "repro_torch.models.xlstm_lm",
    "repro_torch.models.moe", "repro_torch.launch.collectives",
    "repro_torch.launch.specs", "repro_torch.optim.compression",
    "repro_torch.data.vocab_cache", "repro_torch.roofline",
    "repro_torch.roofline.analysis", "repro_torch.roofline.inspect",
    "repro_torch.kernels.probe_ctx", "repro_torch.launch.dryrun",
    "repro_torch.launch.dryrun_gnn",
)

# the static passes: `import repro_torch.analysis` (which every threaded
# module of the port does) must not load them
PASSES = tuple(m for m in REQUIRED if m.startswith("repro_torch.analysis.")
               and m != "repro_torch.analysis.runtime")

BLOCKER = f"REQUIRED = {REQUIRED!r}\n" + r'''
import importlib, importlib.util, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Blocker())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in mods:
    importlib.import_module(name)
missing = set(REQUIRED) - set(mods)
assert not missing, missing
# imported only when a routing table arrives: unpack one
import numpy as np
from repro_torch.rpc import wire
wire.unpack_table({"has_table": True, "n_shards": 1, "table_version": 0},
                  {"shard_of_node": np.zeros(2, np.int16)})
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("imported", len(mods), "modules")
'''


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def test_port_and_smoke_script_import_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", BLOCKER], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split()[1])
    assert n >= 32          # every subpackage and module was walked


def _run_smoke(cwd: Path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""        # this child sees no card
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_the_analysis_package_does_not_load_the_passes():
    code = (f"PASSES = {PASSES!r}\n"
            "import sys, repro_torch.analysis\n"
            "from repro_torch.analysis import guarded_by, holds_lock\n"
            "loaded = [m for m in PASSES if m in sys.modules]\n"
            "assert not loaded, loaded\n"
            "assert 'torch' not in sys.modules\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_smoke_script_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_smoke_script_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
