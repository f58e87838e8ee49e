"""Pod-scale dry-run of the paper's workload, GraphSAGE + GNS (port of
``repro.launch.dryrun_gnn``).

The LM cells (``launch/dryrun.py``) prove the framework; this counts the
paper's own technique at pod scale: the GNS engine's train step
(``gns.engine.make_train_step``, the function ``GNSEngine`` runs) on this
rank's view of the 16x16 (and 2x16x16) production mesh at
ogbn-papers100M's dimensions:

  * cache table [|C| = 1% of 111M = 1.11M rows, 128 feats], row-sharded
    over the cache axis (``model``), refreshed by a shard-aware upload;
  * minibatch: global batch 1024 = one minibatch per data-parallel group,
    this rank's group's padded input layer;
  * input path: ``input_impl="fused"`` with the per-group home-shard
    vector;
  * train step = forward + backward + AdamW on the 3-layer GraphSAGE.

The machinery lives in :mod:`repro_torch.gns.describe`
(``GNSEngine.describe`` on a mesh reports the same record); this module
keeps the production dimensions, the CLI, and ``run(mesh=...)`` for a
reduced mesh.  ``--diff A B`` (preset names or EngineConfig-JSON paths)
prints the describe diff instead, exit status 0 when they are the same
and 1 when they differ.

Writes ``build/dryrun_torch/gnn-graphsage__train_1k__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn
  PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn --diff A B
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.gns.describe import (batch_structs, describe_lowering,  # noqa: F401
                                      diff, placement_traffic_sim)
from repro_torch.launch.mesh import dryrun_mesh

# paper Table 2: ogbn-papers100M; §4.1 setup
NUM_NODES = 111_059_956
FEAT_DIM = 128
NUM_CLASSES = 172
CACHE_FRAC = 0.01
BATCH = 1024     # paper uses 1000; padded to divide the 16-wide data axis
FANOUTS = (15, 10, 5)        # input-first (paper: 15,10,5 top-down)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"


def run(multi_pod: bool = False, *, mesh=None, num_nodes: int = NUM_NODES,
        feat_dim: int = FEAT_DIM, num_classes: int = NUM_CLASSES,
        cache_frac: float = CACHE_FRAC, batch: int = BATCH,
        fanouts=FANOUTS, hidden_dim: int = 256,
        input_impl: str = "fused", fast_path: str = "dynamic") -> dict:
    """Count the engine train step; ``mesh=None``: rank 0 of the
    production mesh, over a ``fake`` world for the call."""
    kw = dict(num_nodes=num_nodes, feat_dim=feat_dim,
              num_classes=num_classes, cache_frac=cache_frac, batch=batch,
              fanouts=tuple(fanouts), hidden_dim=hidden_dim,
              input_impl=input_impl, input_kernel="reference",
              fast_path=fast_path)
    if mesh is not None:
        return describe_lowering(mesh=mesh, **kw)
    with dryrun_mesh((2, 16, 16) if multi_pod else (16, 16)) as m:
        return describe_lowering(mesh=m, **kw)


def _load_config(spec: str):
    """A preset name (``quickstart``) or a path to an EngineConfig JSON."""
    from repro_torch.gns import PRESETS, EngineConfig
    if spec in PRESETS:
        return EngineConfig.preset(spec)
    return EngineConfig.from_dict(json.loads(Path(spec).read_text()))


def main_diff(spec_a: str, spec_b: str, device=None) -> int:
    """``--diff A B``: the describe() diff mode — compare two configs'
    declarative fields and their records.  Exit status as ``diff(1)``'s:
    0 = identical, 1 = they differ.  The engines run on ``device`` (None:
    the GPU)."""
    rec = diff(_load_config(spec_a), _load_config(spec_b), device=device)
    print(json.dumps(rec, indent=1, default=str))
    return 0 if rec["same"] else 1


def main() -> int:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    for mp in (False, True):
        rec = run(multi_pod=mp)
        name = f"gnn-graphsage__train_1k__{'multi' if mp else 'single'}.json"
        (RESULTS_DIR / name).write_text(json.dumps(rec, indent=1))
        r = rec["roofline"]
        print(f"[gnn {rec['mesh']}] dominant={r['dominant']} "
              f"compute={r['compute_s']:.5f}s memory={r['memory_s']:.5f}s "
              f"collective={r['collective_s']:.5f}s "
              f"dp_groups={rec['dp_groups']} fast_path={rec['fast_path']} "
              f"cache/chip={rec['cache_bytes_per_chip'] / 1e6:.1f}MB "
              f"upload/gen={rec['upload_bytes_per_gen_sharded'] / 1e9:.2f}GB "
              f"(vs {rec['upload_bytes_per_gen_replicated'] / 1e9:.2f}GB "
              f"repl.) local-hit={rec['lookup_local_frac_locality']:.2f} "
              f"(vs {rec['lookup_local_frac_contiguous']:.2f} contiguous) "
              f"(count {rec['count_s']}s)", flush=True)
    return 0


if __name__ == "__main__":
    if "--diff" in sys.argv:
        i = sys.argv.index("--diff")
        if len(sys.argv) < i + 3:
            print("usage: dryrun_gnn.py --diff <preset|config.json> "
                  "<preset|config.json> [--device cpu]", file=sys.stderr)
            sys.exit(2)
        dev = (sys.argv[sys.argv.index("--device") + 1]
               if "--device" in sys.argv else None)
        sys.exit(main_diff(sys.argv[i + 1], sys.argv[i + 2], device=dev))
    sys.exit(main())
