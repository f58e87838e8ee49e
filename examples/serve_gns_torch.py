"""Serving quickstart on the PyTorch port: the persistent GNS serving loop
(``repro_torch.serve``), on one CUDA card.

Twin of ``examples/serve_gns.py`` on ``repro_torch``.  Fits a small GNS
engine, then serves a skewed request stream through ``GNSServer``:
requests are coalesced into size-bucketed padded batches (a few fixed
shapes, one per bucket), every batch rides the live cache generation
safely, and the serving traffic feeds the adaptive policy so periodic
refreshes pull the cache toward the inference hot set.  Prints the
latency/traffic snapshot at the end.  The port compiles nothing, so where
the reference prints its compiled inference steps this prints the bucket
shapes served.

Run:  PYTHONPATH=src python examples/serve_gns_torch.py [--requests 200] \\
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.sampler import SamplerConfig
from repro_torch.featurestore import CacheConfig
from repro_torch.gns import EngineConfig, GNSEngine, ServeConfig
from repro_torch.gns.config import DataConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--hot-share", type=float, default=0.9,
                    help="fraction of requests drawn from the hot set")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = EngineConfig(
        sampler="gns",
        data=DataConfig(name="ogbn-products", scale=args.scale),
        sampling=SamplerConfig(batch_size=128, fanouts=(5, 10)),
        cache=CacheConfig(fraction=0.05, strategy="adaptive"),
        serve=ServeConfig(buckets=(16, 64, 128), max_wait_ms=2.0,
                          refresh_every=16,
                          # the example fires the whole stream before
                          # collecting results, so the queue must hold it
                          # (a real client sheds/retries on QueueFull)
                          max_queue=args.requests + 8))
    engine = GNSEngine(cfg, device=args.device)
    print(f"fitting on {engine.ds.graph.num_nodes:,} nodes ...")
    engine.fit(args.epochs, max_batches=20)

    rng = np.random.default_rng(0)
    pool = engine.ds.val_idx
    hot = rng.choice(pool, size=max(len(pool) // 20, 16), replace=False)
    print(f"serving {args.requests} requests "
          f"({args.hot_share:.0%} from a {len(hot)}-node hot set) ...")
    with engine.serve() as server:
        futs = []
        for _ in range(args.requests):
            src = hot if rng.random() < args.hot_share else pool
            ids = rng.choice(src, size=int(rng.integers(2, 10)),
                             replace=False)
            futs.append(server.submit(ids))       # deadline_ms=... optional
        for f in futs:
            logits = f.result(timeout=600).logits
            assert np.isfinite(logits).all()

    snap = server.meter.snapshot()
    traj = server.meter.hit_trajectory()
    k = max(len(traj) // 4, 1)
    shapes = len({rec.bucket for rec in server.meter.batch_log})
    print(f"served {snap['served']}/{snap['submitted']} in "
          f"{snap['batches']} micro-batches "
          f"(fill {snap['fill_fraction']:.0%}, "
          f"bucket shapes served: {shapes})")
    print(f"latency: queue p50/p99 {snap['queue_wait_p50_ms']}/"
          f"{snap['queue_wait_p99_ms']} ms, "
          f"total p50/p99 {snap['total_p50_ms']}/{snap['total_p99_ms']} ms")
    print(f"cache: hit rate {snap['cache_hit_rate']:.2%}, "
          f"hit trajectory {np.mean(traj[:k]):.2f} -> {np.mean(traj[-k:]):.2f} "
          f"over {snap['swaps_observed']} serving-driven refresh swaps")


if __name__ == "__main__":
    main()
