"""Collective and memory census with op provenance (port of
``repro.roofline.inspect``), the dry-run's profiler.

Counts one cell of the dry-run (``launch/dryrun.py``: rank 0's real step
on ``meta`` tensors over a ``fake`` world) and prints its collectives and
its large results grouped by the model line that issued them.  The
reference reads HLO metadata ``op_name`` (the jaxpr path); here the site
is the ``file:line`` the collectives recorder and the step counter take
from the call stack (``launch/collectives.py::call_site``).

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.inspect --arch qwen2-7b \\
      --shape train_4k [--multipod] [--linear]
"""
from __future__ import annotations

import argparse
import collections

from repro_torch.roofline.analysis import _RING


def collective_census(log) -> list:
    """[(wire bytes, op, result bytes, group size, site), ...] descending,
    one row per recorded collective (ring bytes, ``roofline/analysis``)."""
    rows = []
    for r in log:
        s = max(int(r["group"]), 1)
        rows.append((int(_RING[r["op"]](int(r["bytes"]), s)), r["op"],
                     int(r["bytes"]), s, r["site"]))
    rows.sort(reverse=True)
    return rows


def memory_census(sites: dict, top: int = 25) -> list:
    """Result bytes of the ops of at least 1 MB, by (aten op, site) — a
    write-traffic proxy for what inflates the bytes term.  ``sites``: the
    counter's (``StepCounter(sites=True)``).  Prints and returns the
    rows."""
    total = sum(sites.values())
    print(f"\n== memory census (>=1MB results): {total / 1e9:.2f} GB total ==")
    rows = sorted(((b, op, site) for (op, site), b in sites.items()),
                  reverse=True)[:top]
    for b, op, site in rows:
        print(f"  {b / 1e9:8.2f} GB  {op:<22} {site}")
    return rows


def summarize(rows, top: int = 25) -> None:
    total = sum(r[0] for r in rows)
    print(f"collective ops: {len(rows)}, wire bytes/chip: {total / 1e9:.2f} GB")
    by_site = collections.Counter()
    for b, c, _, _, site in rows:
        by_site[(c, site)] += b
    print("\n-- by site --")
    for (c, site), b in by_site.most_common(top):
        print(f"  {b / 1e9:8.2f} GB  {c:<18} {site}")
    print("\n-- largest single ops --")
    for b, c, rb, s, site in rows[:top]:
        print(f"  {b / 1e9:8.2f} GB  {c:<18} g={s:<4} "
              f"result={rb / 1e6:.2f}MB  {site}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--linear", action="store_true",
                    help="linear-attention traffic probe (memory census)")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import cell_step, count_step
    from repro_torch.launch.mesh import dryrun_mesh
    from repro_torch.launch.sharding import arch_scope

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    mesh_shape = (2, 16, 16) if args.multipod else (16, 16)
    mdt = "bfloat16" if cfg.fsdp else "float32"
    with dryrun_mesh(mesh_shape, args.rank) as mesh, arch_scope(cfg):
        run = cell_step(cfg, shape, mesh, mdt)[0]
        counter, log = count_step(run, mesh, linear=args.linear, sites=True)
    rows = collective_census(log)
    print(f"== {args.arch} x {args.shape} (mesh {mesh_shape}, rank "
          f"{args.rank}, executed) ==")
    summarize(rows, top=args.top)
    memory_census(counter.sites, top=args.top)


if __name__ == "__main__":
    main()
