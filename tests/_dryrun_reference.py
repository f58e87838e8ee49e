"""The reference's dry-run numbers for ``tests/test_torch_dryrun.py`` and
``tests/test_torch_dryrun_gnn.py``, computed in a subprocess: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices before jax
starts, which must not happen in a test worker.

``python tests/_dryrun_reference.py lm`` prints, as JSON, for each of the
six reduced families of ``tests/test_dryrun_small.py`` and each kind:
``_param_counts``, ``_sharded_bytes`` of the arguments on the (2, 4) and
(16, 16) meshes, and (train) the FLOPs of ``cost_analysis`` of the
unrolled step on one device.  ``python tests/_dryrun_reference.py gnn``
prints ``describe_lowering``'s records on (2, 2) and (1, 4) meshes and
``dryrun_gnn --diff``'s exit status on two pairs of presets.
"""
import json
import sys

import numpy as np

from repro.launch import dryrun  # noqa: E402  (sets XLA_FLAGS first)

import jax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeSpec  # noqa: E402
from repro.launch import sharding as shlib  # noqa: E402
from repro.launch.specs import input_specs  # noqa: E402
from repro.models.lm import get_model  # noqa: E402
from repro.optim.adam import AdamConfig, AdamW  # noqa: E402

ARCHS = ["qwen2-7b", "deepseek-v2-236b", "zamba2-2.7b", "xlstm-125m",
         "seamless-m4t-medium", "h2o-danube-3-4b"]
SHAPES = {"train": ShapeSpec("t", 32, 8, "train"),
          "decode": ShapeSpec("d", 32, 8, "decode"),
          "prefill": ShapeSpec("p", 32, 8, "prefill")}


def _mesh(d, m):
    return Mesh(np.asarray(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))


def _arg_bytes(cfg, shape, mesh) -> float:
    model = get_model(cfg)
    with shlib.use_mesh(mesh):
        specs = input_specs(cfg, shape, mesh, model=model)
    p_structs, p_sh = specs["params"]
    arg = dryrun._sharded_bytes(p_structs, p_sh, mesh)
    if shape.kind == "train":
        o_structs = jax.eval_shape(AdamW(AdamConfig(lr=3e-4)).init,
                                   p_structs)
        o_sh = {"m": p_sh, "v": p_sh,
                "step": NamedSharding(mesh, PartitionSpec())}
        return arg + dryrun._sharded_bytes(o_structs, o_sh, mesh)
    s_structs, s_sh = specs["state"]
    return arg + dryrun._sharded_bytes(s_structs, s_sh, mesh)


def lm() -> dict:
    out = {}
    meshes = {"2x4": _mesh(2, 4), "16x16": _mesh(16, 16)}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = get_model(cfg)
        with shlib.use_mesh(meshes["2x4"]):
            p_structs = input_specs(cfg, SHAPES["train"], meshes["2x4"],
                                    model=model)["params"][0]
        total, active = dryrun._param_counts(p_structs, cfg)
        rec = {"params_total": total, "params_active": active}
        for kind, shape in SHAPES.items():
            for name, mesh in meshes.items():
                rec[f"arg_{kind}_{name}"] = _arg_bytes(cfg, shape, mesh)
        rec["flops_train_1x1"] = dryrun._compile_probe(
            cfg, SHAPES["train"], _mesh(1, 1))[0]
        out[arch] = rec
    return out


GNN = dict(num_nodes=5000, feat_dim=32, num_classes=8, cache_frac=0.05,
           batch=16, fanouts=(3, 4), hidden_dim=16, input_impl="fused")


def gnn() -> dict:
    from repro.launch import dryrun_gnn
    out = {}
    for d, m in ((2, 2), (1, 4)):
        for fast in ("dynamic", "static", "off"):
            rec = dryrun_gnn.run(mesh=_mesh(d, m), fast_path=fast, **GNN)
            rec.pop("memory_analysis", None)
            out[f"{d}x{m}_{fast}"] = rec
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        out["diff_same"] = dryrun_gnn.main_diff("quickstart", "quickstart")
        out["diff_other"] = dryrun_gnn.main_diff("quickstart", "bench_ci")
    return out


if __name__ == "__main__":
    print("REFERENCE_JSON " + json.dumps({"lm": lm, "gnn": gnn}[
        sys.argv[1]](), default=float))
