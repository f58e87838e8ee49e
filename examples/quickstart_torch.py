"""Quickstart on the PyTorch port: GNS vs node-wise sampling on a synthetic
power-law graph, on one CUDA card.

Twin of ``examples/quickstart.py`` on ``repro_torch``: GNS reaches the same
F1 as NS while moving far fewer feature bytes host->device and far fewer
distinct input nodes per minibatch (paper Tables 3 & 4).  One declarative
``EngineConfig`` preset, one ``GNSEngine`` per sampler, on the GPU unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--epochs 3] \\
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.gns import EngineConfig, GNSEngine
from repro_torch.gns.config import DataConfig
from repro_torch.graph.datasets import get_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    # Table-4 regime: sample tree (batch x prod(fanouts)) << |V|, power-law
    # hubs intact
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--max-batches", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    base = EngineConfig.preset(
        "quickstart",
        data=DataConfig(name=args.dataset, scale=args.scale))
    base = dataclasses.replace(
        base, sampling=dataclasses.replace(base.sampling,
                                           batch_size=args.batch_size))
    ds = get_dataset(args.dataset, scale=args.scale)
    print(f"dataset: {ds.name}  |V|={ds.graph.num_nodes:,} "
          f"|E|={ds.graph.num_edges:,} feat={ds.feat_dim}")

    results = {}
    for name in ("ns", "gns"):
        engine = GNSEngine(dataclasses.replace(base, sampler=name),
                           dataset=ds, device=args.device)
        rep = engine.fit(args.epochs, max_batches=args.max_batches,
                         eval_every=args.epochs)
        results[name] = (rep, engine.meter)
        print(f"\n== {name.upper()} on {engine.device} ==")
        print(f"  epoch time:        {rep.epoch_times[-1]:.2f}s")
        print(f"  final loss:        {rep.losses[-1]:.4f}")
        print(f"  val micro-F1:      {rep.val_acc[-1]:.4f}")
        print(f"  input nodes/batch: {rep.input_nodes_per_batch:,.0f}"
              f"  (cached: {rep.cached_nodes_per_batch:,.0f})")
        print(f"  bytes streamed:    {engine.meter.bytes_streamed/1e6:,.1f} MB")

    ns_bytes = results["ns"][1].bytes_streamed
    gns_bytes = results["gns"][1].bytes_streamed
    ns_in = results["ns"][0].input_nodes_per_batch
    gns_in = results["gns"][0].input_nodes_per_batch
    print(f"\nGNS vs NS:  input nodes {ns_in/max(gns_in,1):.1f}x fewer, "
          f"streamed bytes {ns_bytes/max(gns_bytes,1):.1f}x fewer "
          f"(paper Table 4: 3-6x fewer input nodes)")
    return results


if __name__ == "__main__":
    main()
