#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card.  Phases, one
line each on stdout:

1. build   — compile the port's CUDA kernels (K1 ``cache_lookup_agg``, K2
             ``gather_agg``) from ``src/repro_torch/csrc``;
2. parity  — at the bucket-128 and bucket-512 serving shapes of preset
             ``paper_train``, hold each kernel against its plain PyTorch
             version on the card: ``torch.equal`` on integer-valued f32,
             allclose (rtol 1e-5, atol 1e-6) on random f32 and on a bf16
             table;
3. serve   — ``GNSEngine`` on preset ``paper_train`` with the fused K1 input
             layer and the K2 aggregation serves 64 requests of 1-16 node ids
             through ``GNSServer`` in waves that use all three buckets; every
             request must come back with finite logits, and both kernels'
             launch counters, zeroed just before, must be above 0.  Then, for
             one prepared batch per bucket, the card's logits must match the
             same engine's plain path on the CPU (allclose rtol 1e-4,
             atol 1e-4: cuBLAS and the CPU sum the f32 matmul in different
             orders);
4. times   — each kernel's median time over cold-L2 launches, its bound, the
             plain version's time and, for K2, ``embedding_bag``'s.

Then one JSON line with every kernel's numbers, the card's name and power
limit as ``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero.  Without a CUDA card, or without ``src/repro_torch`` beside
it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
HBM_MS = HBM_BYTES_PER_S / 1e3   # bytes per ms
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BUCKETS = (128, 512)           # timed / parity-checked serving shapes
REPS = 30                      # timed launches per measurement
SEED = 0


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def median_ms(fn, flush) -> float:
    """Median of REPS launches, each timed with CUDA events after the L2
    cache was overwritten (the serving path finds these operands cold)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: int, n_flops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_MS
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_work(feat, idx, w) -> tuple[int, int, int]:
    """Bytes and flops K2 needs on these inputs: each distinct row that a
    lane with w != 0 reads, idx and w once, the output once; two flops per
    element of a live lane.  Also the bytes of the kernel's own reads, one
    row per lane (B*K*D*elt + B*K*8 + B*D*4)."""
    import torch
    live = w != 0
    rows = torch.unique(idx[live]).numel()
    d = feat.shape[1]
    io = idx.numel() * 8 + idx.shape[0] * d * 4
    n_bytes = rows * d * feat.element_size() + io
    lane_bytes = idx.numel() * d * feat.element_size() + io
    return n_bytes, lane_bytes, 2 * int(live.sum()) * d


def lookup_work(cache, streamed, slots, idx, w) -> tuple[int, int, int]:
    """Bytes and flops K1 needs: for each distinct input row that a live
    lane reads, its slot and its live row (cache row on a hit, streamed row
    on a miss), idx and w once, the output once.  Also the bytes of the
    kernel's own reads, a slot and a live row per lane (B*K*D*elt + B*K*12
    + B*D*4)."""
    import torch
    live = w != 0
    rows = torch.unique(idx[live]).long()
    hit = slots[rows] >= 0
    d = cache.shape[1]
    io = idx.numel() * 8 + idx.shape[0] * d * 4
    n_bytes = (int(hit.sum()) * d * cache.element_size()
               + int((~hit).sum()) * d * 4 + rows.numel() * 4 + io)
    lane_hits = int((slots[idx.long()] >= 0).sum())
    lane_bytes = (lane_hits * d * cache.element_size()
                  + (idx.numel() - lane_hits) * d * 4 + idx.numel() * 4 + io)
    return n_bytes, lane_bytes, 2 * int(live.sum()) * d


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_engine():
    from repro_torch.gns import EngineConfig, GNSEngine, ModelConfig
    cfg = EngineConfig.preset(
        "paper_train", seed=SEED,
        model=ModelConfig(hidden_dim=256, aggregate_impl="pallas",
                          input_impl="fused"))
    # a 20 ms coalescing window (default 2 ms) so that each wave below lands
    # in one micro-batch; the buckets stay the default (32, 128, 512)
    cfg = dataclasses.replace(
        cfg, serve=dataclasses.replace(cfg.serve, max_wait_ms=20.0))
    return GNSEngine(cfg)             # on the GPU: no device= given


def serving_shapes(engine, rng):
    """One prepared batch per timed bucket, its arrays on the card."""
    out = {}
    for b in BUCKETS:
        ids = rng.choice(engine.ds.graph.num_nodes, b, replace=False)
        mb = engine.infer_prepare(ids, bucket=b, rng=rng)
        out[b] = (mb, mb.device.to(engine.device))
        log("batch", bucket=b, input_rows_padded=len(mb.input_node_ids),
            input_nodes=mb.num_input, cached=mb.num_cached,
            streamed_mb=round(mb.device.input_streamed.nbytes / 1e6, 1),
            miss_mb=round(mb.bytes_streamed / 1e6, 2))
    return out


def phase_parity(engine, shapes, rng) -> dict:
    """Kernel vs plain version at the serving shapes.  Returns the largest
    |kernel - plain| on random f32 per (kernel, bucket, layer)."""
    import torch
    from repro_torch.kernels.cache_lookup import (cache_lookup_agg_cuda,
                                                  cache_lookup_agg_plain)
    from repro_torch.kernels.gather_agg import (gather_agg_cuda,
                                                gather_agg_plain)
    dev = engine.device
    cases = (("int", torch.float32), ("rand", torch.float32),
             ("rand", torch.bfloat16))     # (data, table dtype)
    errs = {}

    def table(shape, kind, dtype=torch.float32):
        if kind == "int":
            a = rng.integers(-128, 129, shape).astype(np.float32)
        else:
            a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype=dtype)

    def weights(like, kind):
        if kind == "int":
            a = rng.integers(-8, 9, like.shape).astype(np.float32)
        else:
            a = like.cpu().numpy()       # the sampler's own weights
        return torch.from_numpy(a).to(dev)

    def hold(name, b, layer, kind, dtype, kernel, plain, args, idx):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if kind == "int":
            ok = torch.equal(got, want)
        else:
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
        log("parity", kernel=name, bucket=b, layer=layer, data=kind,
            table=str(dtype).removeprefix("torch."), B=idx.shape[0],
            K=idx.shape[1], D=got.shape[1], max_abs_err=err, ok=ok)
        if not ok:
            raise AssertionError(f"{name} b={b} layer {layer} {kind} "
                                 f"{dtype}: max err {err}")
        if kind == "rand" and dtype == torch.float32:
            errs[(name, b, layer)] = err

    cache_rows = engine.store.generation.table.shape[0]
    for b, (_, db) in shapes.items():
        blk0 = db.blocks[0]
        for kind, dtype in cases:
            args = (table((cache_rows, engine.ds.feat_dim), kind, dtype),
                    table(tuple(db.input_streamed.shape), kind),
                    db.input_cache_slots, blk0.nbr_idx,
                    weights(blk0.nbr_w, kind))
            hold("cache_lookup_agg", b, 0, kind, dtype,
                 cache_lookup_agg_cuda, cache_lookup_agg_plain, args,
                 blk0.nbr_idx)
        for li in (1, 2):
            blk = db.blocks[li]
            n_src = db.blocks[li - 1].nbr_idx.shape[0]
            for kind, dtype in cases:
                args = (table((n_src, engine.mcfg.hidden_dim), kind, dtype),
                        blk.nbr_idx, weights(blk.nbr_w, kind))
                hold("gather_agg", b, li, kind, dtype, gather_agg_cuda,
                     gather_agg_plain, args, blk.nbr_idx)
    return errs


def phase_serve(engine, rng) -> dict:
    """Serve request waves through GNSServer; returns the launch counts of
    this run (counters zeroed just before it, read just after)."""
    from repro_torch.kernels import cache_lookup, gather_agg
    n_cls = engine.mcfg.num_classes
    num_nodes = engine.ds.graph.num_nodes
    # wave sizes in requests: 1 request (bucket 32), 7 (33..112 ids, bucket
    # 128 unless all are tiny), then 56 (bucket 512): 64 requests in all
    waves = [[int(rng.integers(1, 17))],
             [int(rng.integers(5, 17)) for _ in range(7)],
             [int(rng.integers(1, 17)) for _ in range(56)]]
    waves[1][0] = 16
    waves[1][1] = 16
    waves[1][2] = 16                  # >= 48 ids: never fits bucket 32
    cache_lookup.launches.reset()
    gather_agg.launches.reset()
    t0 = time.perf_counter()
    results = []
    with engine.serve() as server:
        for sizes in waves:
            futs = [(n, server.submit(rng.integers(0, num_nodes, n)))
                    for n in sizes]
            for n, fut in futs:
                res = fut.result(timeout=300)
                if res.status != "ok":
                    raise AssertionError(f"request status {res.status}")
                if res.logits.shape != (n, n_cls) or \
                        not np.isfinite(res.logits).all():
                    raise AssertionError("bad logits for a served request")
                results.append(res)
    counts = {"cache_lookup_agg": cache_lookup.launches.value,
              "gather_agg": gather_agg.launches.value}
    wall = time.perf_counter() - t0
    snap = server.meter.snapshot()
    buckets = sorted({r.bucket for r in results})
    log("serve", requests=len(results), batches=snap["batches"],
        buckets=buckets, launches_k1=counts["cache_lookup_agg"],
        launches_k2=counts["gather_agg"], wall_s=round(wall, 3),
        total_p50_ms=snap["total_p50_ms"], total_p99_ms=snap["total_p99_ms"],
        cache_hit_rate=snap["cache_hit_rate"])
    if len(results) != 64:
        raise AssertionError(f"{len(results)} of 64 requests served")
    if buckets != [32, 128, 512]:
        raise AssertionError(f"buckets used {buckets}, expected all three")
    if counts["cache_lookup_agg"] < 1 or counts["gather_agg"] < 1:
        raise AssertionError(f"a kernel was never launched: {counts}")
    return counts


def phase_engine_parity(engine, rng) -> None:
    """The card's logits vs the same engine's plain path on the CPU."""
    import torch
    from repro_torch.models import graphsage
    params_cpu = {"layers": [{k: v.cpu() for k, v in layer.items()}
                             for layer in engine.params["layers"]]}
    for b in (32, 128, 512):
        ids = rng.choice(engine.ds.graph.num_nodes, b, replace=False)
        mb = engine.infer_prepare(ids, bucket=b, rng=rng)
        on_card = engine.infer_compute(mb)
        with torch.inference_mode():
            on_cpu = graphsage.forward(
                params_cpu, mb.device.to("cpu"), mb.cache_gen.table.cpu(),
                engine.mcfg).numpy()
        err = float(np.abs(on_card - on_cpu).max())
        ok = np.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)
        log("engine-parity", bucket=b, logits=list(on_card.shape),
            max_abs_err=err, ok=ok)
        if not ok or not np.isfinite(on_card).all():
            raise AssertionError(f"card vs CPU logits differ at b={b}: {err}")


def phase_times(engine, shapes, errs, counts) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.cache_lookup import (cache_lookup_agg_cuda,
                                                  cache_lookup_agg_plain)
    from repro_torch.kernels.gather_agg import (gather_agg_cuda,
                                                gather_agg_plain)
    dev = engine.device
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > L2
    table = engine.store.generation.table
    rows = []
    for b, (_, db) in shapes.items():
        blk0 = db.blocks[0]
        args = (table, db.input_streamed, db.input_cache_slots, blk0.nbr_idx,
                blk0.nbr_w)
        n_bytes, lane_bytes, n_flops = lookup_work(*args)
        t_bound, by = bound_ms(n_bytes, n_flops)
        rows.append({
            "name": f"cache_lookup_agg[b={b},layer=0]", "route": "cuda",
            "source": "src/repro_torch/csrc/cache_lookup.cu",
            "replaces": "src/repro/kernels/cache_lookup.py:78",
            "launches": counts["cache_lookup_agg"],
            "max_abs_err": errs[("cache_lookup_agg", b, 0)],
            "ms": median_ms(lambda: cache_lookup_agg_cuda(*args), flush),
            "plain_ms": median_ms(lambda: cache_lookup_agg_plain(*args), flush),
            "bound_ms": t_bound, "bound_by": by, "library_ms": None,
            "bytes": n_bytes, "lane_bound_ms": lane_bytes / HBM_MS})
        h = torch.randn((blk0.nbr_idx.shape[0], engine.mcfg.hidden_dim),
                        device=dev)
        for li in (1, 2):
            blk = db.blocks[li]
            feat = h[: db.blocks[li - 1].nbr_idx.shape[0]].contiguous()
            idx, w = blk.nbr_idx, blk.nbr_w
            n_bytes, lane_bytes, n_flops = gather_work(feat, idx, w)
            t_bound, by = bound_ms(n_bytes, n_flops)
            rows.append({
                "name": f"gather_agg[b={b},layer={li}]", "route": "cuda",
                "source": "src/repro_torch/csrc/gather_agg.cu",
                "replaces": "src/repro/kernels/gather_agg.py:51",
                "launches": counts["gather_agg"],
                "max_abs_err": errs[("gather_agg", b, li)],
                "ms": median_ms(lambda: gather_agg_cuda(feat, idx, w), flush),
                "plain_ms": median_ms(lambda: gather_agg_plain(feat, idx, w),
                                      flush),
                "bound_ms": t_bound, "bound_by": by,
                "library_ms": median_ms(lambda: F.embedding_bag(
                    idx, feat, per_sample_weights=w, mode="sum"), flush),
                "bytes": n_bytes, "lane_bound_ms": lane_bytes / HBM_MS})
    for r in rows:
        log("time", **{k: r[k] for k in ("name", "ms", "bound_ms", "bound_by",
                                         "plain_ms", "library_ms", "bytes",
                                         "lane_bound_ms")})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._ext import load_kernels

    card = nvidia_smi()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()
    load_kernels()
    log("build", seconds=round(time.perf_counter() - t0, 1))

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    engine = build_engine()
    engine.ensure_cache(np.random.default_rng(SEED))
    log("engine", nodes=engine.ds.graph.num_nodes,
        cache_rows=engine.store.generation.table.shape[0],
        seconds=round(time.perf_counter() - t0, 1))
    shapes = serving_shapes(engine, rng)
    errs = phase_parity(engine, shapes, rng)
    counts = phase_serve(engine, rng)
    phase_engine_parity(engine, rng)
    rows = phase_times(engine, shapes, errs, counts)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
