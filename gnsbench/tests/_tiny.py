"""A tiny cell on the CPU: a root of its own with the harness's traffic
layout, the real metric readers and the products cell's limits."""
import json
import shutil
from pathlib import Path

from gnsbench import harness

TINY_DATA = {"nodes": 3000, "avg_degree": 12, "feat_dim": 16,
             "num_classes": 5, "train_frac": 0.4, "val_frac": 0.05,
             "alpha": 2.1, "p_in": 0.8, "feature_noise": 1.5,
             "data_seed": 3}
TINY_TRAFFIC = {"kind": "train", "batch_size": 64, "fanouts": [5, 10, 15],
                "cache_fraction": 0.1, "cache_strategy": "auto",
                "refresh_period": 1, "prefetch_depth": 2, "warmup_steps": 4,
                "check_steps": 3}


def tiny_root(tmp: Path, data: dict = TINY_DATA,
              traffic: dict = TINY_TRAFFIC) -> Path:
    """``tmp`` laid out as the benchmark's directory, with one cell,
    ``tiny.train``."""
    root = tmp / "bench"
    shutil.copytree(harness.BENCH_DIR / "metrics", root / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "workloads"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    products = harness.load_cell("products.train.gns")
    cfg = dict(products.config, name="tiny", data=data)
    cfg["model"] = dict(cfg["model"], hidden_dim=32)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (root / "traffic" / "train.tiny.json").write_text(json.dumps(traffic))
    # a draw's z grows as the root of the cache's size: the most probable
    # 300 nodes read 14 here (191 at ogbn-products' 24,490), a draw 1.6-2.2
    limits = dict(products.workload["limits"], draw_z=8.0)
    wl = dict(products.workload, config="tiny", traffic="train.tiny",
              limits=limits)
    (root / "workloads" / "tiny.train.json").write_text(json.dumps(wl))
    return root
