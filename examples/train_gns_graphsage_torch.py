"""End-to-end training on the PyTorch port: 3-layer GraphSAGE + GNS (or a
baseline sampler) on an ogbn-products-like graph, on one CUDA card.

Twin of ``examples/train_gns_graphsage.py`` on ``repro_torch``: the paper's
training setup (§4.1) through the engine API (``repro_torch.gns``):
degree-based cache sampling (1% of |V|), cache-prioritized neighbor
sampling with eq. (10)-(12) importance correction, prefetched host
pipeline, AdamW(3e-3), checkpointing with restart through
``repro_torch.checkpoint.CheckpointManager``, and the Fig. 1/2 runtime
breakdown printed at the end.  ``--input-impl fused`` runs layer 0 through
the hand-written K1 kernel.  The engine runs on the GPU unless ``--device
cpu`` is given; there is no ``--mesh`` (the port runs on one device).

Run:  PYTHONPATH=src python examples/train_gns_graphsage_torch.py \\
          [--sampler gns|ns|ladies|lazygcn] [--steps 300] [--scale 0.5] \\
          [--input-impl where|fused] [--ckpt-dir DIR] [--infer 64] \\
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.sampler import SamplerConfig
from repro_torch.featurestore import POLICIES, CacheConfig
from repro_torch.gns import EngineConfig, GNSEngine
from repro_torch.gns.config import DataConfig, ModelConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sampler", default="gns",
                    choices=["gns", "ns", "ladies", "lazygcn"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--cache-frac", type=float, default=0.01)
    ap.add_argument("--cache-policy", default="auto",
                    choices=["auto", *sorted(POLICIES)],
                    help="cache-admission policy (featurestore registry)")
    ap.add_argument("--async-refresh", action="store_true",
                    help="double-buffered background cache refresh")
    ap.add_argument("--input-impl", default="where",
                    choices=["where", "fused"],
                    help="layer 0: 'where' (plain torch) or 'fused' (K1)")
    ap.add_argument("--infer", type=int, default=0, metavar="N",
                    help="after training, run mini-batch inference on N "
                         "validation nodes through the live cache")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from the newest checkpoint here, and save "
                         "one at the end")
    ap.add_argument("--prefetch", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = EngineConfig(
        sampler=args.sampler,
        data=DataConfig(name=args.dataset, scale=args.scale),
        sampling=SamplerConfig(batch_size=args.batch_size,
                               fanouts=(5, 10, 15)),
        cache=CacheConfig(fraction=args.cache_frac, period=1,
                          strategy=args.cache_policy,
                          async_refresh=args.async_refresh),
        model=ModelConfig(input_impl=args.input_impl),
        prefetch=args.prefetch)
    engine = GNSEngine(cfg, device=args.device)
    ds = engine.ds
    print(f"{ds.name}: |V|={ds.graph.num_nodes:,} |E|={ds.graph.num_edges:,} "
          f"train={len(ds.train_idx):,} feat={ds.feat_dim} "
          f"device={engine.device}")

    steps_per_epoch = max(len(ds.train_idx) // args.batch_size, 1)
    epochs = max(args.steps // steps_per_epoch, 1)
    mgr = CheckpointManager(args.ckpt_dir, every=1) if args.ckpt_dir else None
    start = 0
    if mgr:
        tree, start, _ = mgr.restore_or_init(
            (engine.params, engine.opt_state), device=engine.device)
        engine.params, engine.opt_state = tree
        if start:
            print(f"resumed from the checkpoint of epoch {start} "
                  f"(optimizer step {engine.opt_state['step']})")

    rep = engine.fit(epochs, eval_every=1)
    if mgr:
        mgr.maybe_save(start + epochs, (engine.params, engine.opt_state))

    print(f"\n== {args.sampler.upper()} on {ds.name} "
          f"({epochs} epochs x {steps_per_epoch} steps) ==")
    print(f"loss: {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}")
    print(f"val micro-F1: {[round(a, 4) for a in rep.val_acc]}")
    print(f"epoch times (s): {[round(t, 2) for t in rep.epoch_times]}")
    print(f"input nodes/batch: {rep.input_nodes_per_batch:,.0f} "
          f"(cached {rep.cached_nodes_per_batch:,.0f}, "
          f"isolated {rep.isolated_per_batch:.1f})")
    print("runtime breakdown (paper Fig. 2):")
    print(json.dumps(engine.meter.breakdown(), indent=2))
    if engine.store is not None:
        dev = engine.meter.tier("device")
        print(f"feature store: policy={engine.store.policy.name} "
              f"generations={engine.store.refreshes} "
              f"swaps={engine.store.swaps} "
              f"device hit-rate={dev.hit_rate:.3f}")
    if args.infer:
        ids = ds.val_idx[:args.infer]
        logits = engine.infer(ids)
        preds = logits.argmax(axis=-1)
        acc = float((preds == ds.labels[ids]).mean())
        print(f"infer: {len(ids)} nodes through the live cache generation, "
              f"top-1 agreement with labels {acc:.3f}")
    return rep


if __name__ == "__main__":
    main()
