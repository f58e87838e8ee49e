#!/usr/bin/env python3
"""Tile sizes of K1, K2 and K3 on one CUDA card: a sweep.

    python3 scripts/tile_sweep.py [--reps 30]

Run from the root of a checkout on a host with a CUDA card.  It builds the
port's kernels, prints the build read-back of ``chip_smoke.py``
(``[kbuild]``, ``[k4-build]``), then times K1 (``cache_lookup_agg``), K2
(``gather_agg``) and K3 (``gns_sample_agg``) at the main path's shapes of
preset ``paper_train`` for several tile sizes (rows per block, passed to
the kernels' bindings in place of their own plan), in turns within one
call with the wrappers (the kernels' own plan, ``tiles=auto``), each
launch after a 96 MB write that evicts L2 (the timing of
``chip_smoke.turns_ms``).  Every tile size, and the wrapper, is first held
bitwise equal to the plain version.  K1's operands are the main path's
own, sampled from preset ``paper_train`` as ``chip_smoke.py`` samples
them (the host-fused training batch, and one batch per serving bucket).
K2's and K3's are synthetic, drawn from a seed: K2's rows are uniform
over 16 times B source rows, K3 draws over a 305-row table with 99.8% of
the destinations uncached, as at the training shape.  One ``[sweep]``
line per shape and tile size, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
# (B, K, D): K2 at buckets 128 and 512, layers 1 and 2; K3 at the training
# shape and bucket 128.  K1 at the training shape (B = 176,000) and buckets
# 128 and 512 (B = 22,528 and 90,112), K = 5, D = 100, and at LADIES's
# training shape (B = 2,024, K = 32, D = 100, every lane a miss)
K2_SHAPES = {"b=128,layer=1": (2048, 10, 256),
             "b=128,layer=2": (128, 15, 256),
             "b=512,layer=1": (8192, 10, 256),
             "b=512,layer=2": (512, 15, 256)}
K3_SHAPES = {"train": (176000, 5, 100), "b=128": (22528, 5, 100)}
K2_ROWS = (1, 2, 4, 8, 16)
K3_ROWS = (2, 5, 10, 20, 40, 64)
K1_ROWS = (1, 2, 5, 10, 20, 40, 64)
TABLE_ROWS = 305


def k2_operands(bsz: int, k: int, d: int, rng, device="cuda"):
    import torch
    n = 16 * bsz
    feat = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (bsz, k)).astype(np.int32))
    w = torch.from_numpy(rng.random((bsz, k)).astype(np.float32))
    return tuple(t.to(device) for t in (feat, idx, w))


def k3_operands(bsz: int, k: int, d: int, rng, device="cuda"):
    import torch
    from repro_torch.sampling.adjacency import DeviceCacheAdj
    counts = rng.integers(0, 3 * k + 1, TABLE_ROWS)
    indptr = np.zeros(TABLE_ROWS + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = np.zeros(1 << (max(1024, nnz) - 1).bit_length(), np.int32)
    indices[:nnz] = rng.integers(0, TABLE_ROWS, nnz)
    deg = rng.integers(1, 60, TABLE_ROWS).astype(np.float32)
    hitp = rng.random(TABLE_ROWS).astype(np.float32)
    adj = DeviceCacheAdj(*(torch.from_numpy(a).to(device)
                           for a in (indptr, indices, deg, hitp)))
    dst = rng.integers(0, TABLE_ROWS, bsz).astype(np.int32)
    dst[rng.random(bsz) < 0.998] = -1
    fb_rows = rng.integers(-1, TABLE_ROWS, (bsz, k)).astype(np.int32)
    fb_w = np.where(fb_rows >= 0, rng.random((bsz, k)), 0.0).astype(
        np.float32)
    table = rng.normal(size=(TABLE_ROWS, d)).astype(np.float32)
    key = rng.integers(0, 2 ** 32, size=(1, 2), dtype=np.uint32)
    return (adj, torch.from_numpy(table).to(device),
            *(torch.from_numpy(a).to(device) for a in (dst, fb_rows, fb_w)),
            key)


def k1_operands(rng) -> dict:
    """K1's operands at its four main-path shapes, on the card: the
    host-fused training batch, one serving batch per bucket and one LADIES
    training batch of preset ``paper_train``."""
    import chip_smoke
    from repro_torch.gns import GNSEngine
    from repro_torch.graph.datasets import get_dataset
    cfg = chip_smoke.train_config("fused")
    ds = get_dataset(cfg.data.name, scale=cfg.data.scale, seed=cfg.data.seed)
    train = GNSEngine(cfg, dataset=ds)
    train.ensure_cache(np.random.default_rng(SEED))
    out = {"train": chip_smoke.host_train_batch(train, rng)}
    ladies = GNSEngine(chip_smoke.baseline_config("ladies"), dataset=ds)
    out["ladies"] = chip_smoke.host_train_batch(ladies, rng)
    serve = chip_smoke.build_engine(ds)
    serve.ensure_cache(np.random.default_rng(SEED))
    for b, (mb, db) in chip_smoke.serving_shapes(serve, rng).items():
        blk0 = db.blocks[0]
        out[f"b={b}"] = (mb.cache_gen.table, db.input_streamed,
                         db.input_cache_slots, blk0.nbr_idx, blk0.nbr_w)
    return out


def k1_tiles(cache, streamed, slots, idx, w, rows: int):
    """K1 through its binding with ``rows`` rows per tile."""
    import torch
    from repro_torch.kernels._ext import load_kernels
    from repro_torch.kernels.cache_lookup import lookup_access_path
    out = torch.empty((idx.shape[0], cache.shape[1]), device=cache.device)
    load_kernels().cache_lookup_agg(
        cache, streamed, slots, idx, w, out,
        lookup_access_path(cache, streamed) == "vector", rows)
    return out


def k2_tiles(feat, idx, w, rows: int):
    """K2 through its binding with ``rows`` rows per tile."""
    import torch
    from repro_torch.kernels._ext import load_kernels
    from repro_torch.kernels.gather_agg import access_path
    out = torch.empty((idx.shape[0], feat.shape[1]), device=feat.device)
    load_kernels().gather_agg(feat, idx, w, out,
                              access_path(feat) == "vector", rows)
    return out


def k3_tiles(adj, table, dst, fb_rows, fb_w, key, rows: int):
    """K3 through its binding with ``rows`` rows per tile (no lane
    outputs)."""
    import torch
    from repro_torch.kernels._ext import load_kernels
    from repro_torch.kernels.gather_agg import access_path
    from repro_torch.sampling.kernels import key_words
    out = torch.empty((dst.shape[0], table.shape[1]), device=table.device)
    none = torch.empty(0, dtype=torch.int32, device=table.device)
    load_kernels().gns_sample_agg(
        *adj.tensors(), table, dst, fb_rows, fb_w, *key_words(key), out,
        none, none.float(), False, 0, table.shape[0],
        access_path(table) == "vector", rows)
    return out


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=30)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import cache_lookup as k1
    from repro_torch.kernels import gather_agg as k2
    from repro_torch.kernels.gather_agg import access_path
    from repro_torch.sampling import kernels as k3
    chip_smoke.REPS = opts.reps
    chip_smoke.phase_kbuild()
    rng = np.random.default_rng(SEED)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for name, shape in K2_SHAPES.items():
        args = k2_operands(*shape, rng)
        cases.append(("gather_agg", name, shape, args, access_path(args[0]),
                      K2_ROWS, k2.gather_agg_cuda, k2.gather_agg_plain,
                      k2_tiles))
    for name, shape in K3_SHAPES.items():
        args = k3_operands(*shape, rng)
        cases.append(("gns_sample_agg", name, shape, args,
                      access_path(args[1]), K3_ROWS, k3.gns_sample_agg_cuda,
                      k3.gns_sample_agg_plain, k3_tiles))
    for name, args in k1_operands(rng).items():
        cases.append(("cache_lookup_agg", name,
                      (*args[3].shape, args[0].shape[1]), args,
                      k1.lookup_access_path(*args[:2]), K1_ROWS,
                      k1.cache_lookup_agg_cuda, k1.cache_lookup_agg_plain,
                      k1_tiles))
    for (kernel, name, (bsz, k, d), args, path, sizes, new, plain,
         tiles) in cases:
        want = plain(*args)
        fns = {"auto": lambda: new(*args)}
        for rows in sizes:
            fns[f"rows={rows}"] = (lambda r: lambda: tiles(*args, r))(rows)
        for label, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{kernel}[{name}] {label} differs "
                                     f"from the plain version")
        del want
        times = chip_smoke.turns_ms(fns, flush)
        for label, ms in times.items():
            chip_smoke.log("sweep", kernel=kernel, shape=name, B=bsz, K=k,
                           D=d, path=path, tiles=label, ms=ms)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
