"""The reference's ``train_loop(mesh=)`` over forced host devices, for the
LM mesh tests: ``python tests/_lm_mesh_reference.py CELLS.json OUT.json``.

``CELLS.json`` holds a list of ``{"name", "arch", "kw", "mesh": [data,
model] or null, "steps", "batch", "seq_len", "lr"}``; ``OUT.json`` gets
``{name: losses}``.  ``LM_MESH_REF_DEVICES`` in the environment sets the
number of forced host devices (default 4; a (2, 3) mesh needs 6).  The
mesh is built as ``tests/test_dryrun_small.py``
builds its own (``jax.sharding.Mesh`` over the first data·model devices,
the default Auto axes): the reference's ``make_host_mesh``
(``jax.make_mesh``) gives Explicit axes on jax 0.9, which its LM trainer
does not run on.  Runs go two at a time on threads (each ``use_mesh`` is
thread-local).
"""
import os
import sys

# 4 host devices unless the caller says; the backend's cheapest codegen
# (half the compile time, losses within 1e-6 of the default's)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           f"{int(os.environ.get('LM_MESH_REF_DEVICES', 4))} "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402


def run(cell: dict) -> tuple:
    cfg = get_config(cell["arch"]).reduced()
    cfg = dataclasses.replace(cfg, **{      # a dict: a nested config's
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in cell["kw"].items()})
    mesh = None
    if cell["mesh"] is not None:
        d, m = cell["mesh"]
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))
    rep = jtrain.train_loop(cfg, steps=cell["steps"], batch=cell["batch"],
                            seq_len=cell["seq_len"], mesh=mesh,
                            lr=cell["lr"], log_every=0)
    return cell["name"], rep.losses


def main(cells_path: str, out_path: str) -> None:
    with open(cells_path) as f:
        cells = json.load(f)
    with ThreadPoolExecutor(2) as ex:
        out = dict(ex.map(run, cells))
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
