"""GNS applied to LM embedding tables: the hot-vocab cache demo (the
PyTorch twin of ``examples/vocab_cache_demo.py``).

The paper's mechanism (a frequency-biased device cache + streamed misses +
periodic refresh) on the LM substrate: a Zipf token stream against a
large-vocab embedding table kept in host memory.  Prints the hit rate and
the host->device bytes saved per refresh period, the LM analog of the
paper's Tables 4/6, as the reference's demo prints them; every batch is
also looked up on the device (``embed_with_cache``) and must equal the
table's rows exactly.

Run:  PYTHONPATH=src python examples/vocab_cache_demo_torch.py \\
          [--vocab 152064] [--frac 0.01] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data.tokens import SyntheticCorpus
from repro_torch.data.vocab_cache import (VocabCache, VocabCacheConfig,
                                          embed_with_cache)
from repro_torch.device import resolve_device
from repro_torch.featurestore import TrafficMeter


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=152064)   # qwen2-7b vocab
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--frac", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--zipf", type=float, default=1.2)
    ap.add_argument("--device", default=None,
                    help="torch device of the cache (default: the GPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    table = rng.standard_normal((args.vocab, args.dim)).astype(np.float32)
    corpus = SyntheticCorpus(args.vocab, zipf_a=args.zipf, seed=1)

    for strategy in ("topk", "sampled"):
        vc = VocabCache(table, VocabCacheConfig(fraction=args.frac,
                                                strategy=strategy),
                        device=dev)
        meter = TrafficMeter()
        nocache_bytes = 0
        hits = []
        for step in range(args.steps):
            toks = corpus.batch(0, step, batch=16, seq_len=512)
            vc.observe(toks)
            if step % 5 == 0:                       # periodic refresh (P=5)
                vc.refresh(step, meter)
            batch = vc.assemble(toks, meter, device=dev)
            h = embed_with_cache(vc.table, batch)
            if not np.array_equal(h.cpu().numpy(), table[toks]):
                raise AssertionError(f"step {step}: the cached lookup "
                                     "differs from the table's rows")
            hits.append(vc.hit_rate(toks))
            nocache_bytes += np.unique(toks).size * args.dim * 4
        saved = 1 - meter.bytes_streamed / nocache_bytes
        print(f"[{strategy:>7}] cache {args.frac:.1%} of vocab "
              f"({vc.size:,} rows): hit rate {np.mean(hits[5:]):.1%}, "
              f"streamed {meter.bytes_streamed/1e6:.1f} MB vs "
              f"{nocache_bytes/1e6:.1f} MB uncached "
              f"({saved:.1%} saved; cache fills "
              f"{meter.bytes_cache_fill/1e6:.1f} MB)")


if __name__ == "__main__":
    torch.set_grad_enabled(False)
    main()
