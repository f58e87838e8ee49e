"""Multi-tenant fabric quickstart on the PyTorch port: a worker fleet over
one shared cache, on one CUDA card.

Twin of ``examples/serve_fabric.py`` on ``repro_torch``.  Fits a small GNS
engine, then serves two tenants with very different contracts through
:class:`~repro_torch.serve.ServeFabric`:

* ``mobile`` — latency-sensitive, weight 2.0, small per-tenant queue;
* ``batch``  — throughput traffic, weight 1.0, deep queue, oversubscribed
  on purpose so it sheds (``QueueFull``) at ITS OWN quota.

Each worker runs a weighted-fair stride scheduler feeding the same
size-bucketed micro-batcher ``GNSServer`` uses; on a CUDA card every batch's
layer 0 runs the fused cache-lookup kernel (K1) and its upper layers the
gather-aggregate kernel (K2).  With ``--kill-worker`` one worker is killed
midway to show the watchdog reclaiming its in-flight requests onto the
survivor.  Prints the per-tenant latency/shed breakdown at the end.

Run:  PYTHONPATH=src python examples/serve_fabric_torch.py [--requests 200] \\
          [--kill-worker] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core.sampler import SamplerConfig
from repro_torch.featurestore import CacheConfig
from repro_torch.gns import (EngineConfig, FabricConfig, GNSEngine,
                             ModelConfig, ServeConfig, TenantConfig)
from repro_torch.gns.config import DataConfig
from repro_torch.serve import QueueFull


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--fit-batches", type=int, default=20)
    ap.add_argument("--kill-worker", action="store_true",
                    help="kill worker 0 mid-stream to exercise failover")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = EngineConfig(
        sampler="gns",
        data=DataConfig(name=args.dataset, scale=args.scale),
        sampling=SamplerConfig(batch_size=128, fanouts=(5, 10)),
        cache=CacheConfig(fraction=0.05, strategy="adaptive"),
        model=ModelConfig(input_impl="fused"),
        serve=ServeConfig(buckets=(16, 64), max_wait_ms=2.0))
    engine = GNSEngine(cfg, device=args.device)
    print(f"fitting on {engine.ds.graph.num_nodes:,} nodes "
          f"({engine.device}) ...")
    engine.fit(1, max_batches=args.fit_batches)
    # K2 is forward-only (as in the reference), so training aggregates with
    # the plain reference path and serving switches the upper layers to K2
    engine.mcfg = dataclasses.replace(engine.mcfg, aggregate_impl="pallas")

    fab = engine.serve_fabric(FabricConfig(
        workers=args.workers,
        tenants=(
            TenantConfig("mobile", weight=2.0, max_queue=args.requests + 8),
            # oversubscribed on purpose: sheds at its own quota
            TenantConfig("batch", weight=1.0, max_queue=16))))

    rng = np.random.default_rng(0)
    pool = engine.ds.val_idx
    futs, shed = [], 0
    print(f"serving {args.requests} mobile + {args.requests} batch requests "
          f"across {args.workers} workers ...")
    with fab:
        for i in range(args.requests):
            ids = rng.choice(pool, size=int(rng.integers(2, 10)),
                             replace=False)
            futs.append(fab.submit(ids, tenant="mobile"))
            try:
                fab.submit(rng.choice(pool, size=4), tenant="batch")
            except QueueFull:
                shed += 1                     # batch's problem, not mobile's
            if args.kill_worker and i == args.requests // 2:
                fab.workers[0].kill()
                print("killed worker 0 — watchdog re-routes its queue "
                      "and reclaims in-flight requests ...")
        for f in futs:
            r = f.result(timeout=600)
            assert r.status == "ok" and np.isfinite(r.logits).all()

    snap = fab.meter.snapshot()
    t = snap["tenants"]
    print(f"served {snap['served']}/{snap['submitted']} in "
          f"{snap['batches']} micro-batches "
          f"(fill {snap['fill_fraction']:.0%}, shed {shed} batch requests)")
    for name in ("mobile", "batch"):
        ts = t[name]
        print(f"  {name:>6}: served {ts['served']:>4}  "
              f"rejected {ts['rejected']:>4}  "
              f"p50/p99 {ts['total_p50_ms']}/{ts['total_p99_ms']} ms")
    if args.kill_worker:
        rt = snap["routing"]
        print(f"failovers {rt['failovers']}, retries {rt['retries']}, "
              f"healthy workers at exit: {sorted(fab.healthy())}")
    assert t["mobile"]["rejected"] == 0       # isolation: mobile never shed
    assert snap["errors"] == 0 and fab.fabric_error is None


if __name__ == "__main__":
    main()
