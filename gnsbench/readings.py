"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card: the program on each of ``--seeds`` (the lower
readings), the control (the reference in TF32 in the program's place) on
the first ``--control`` of them, and each fault of ``--faults`` on the
first ``--fault-seeds`` seeds (the upper readings).  No measured window:
each seed builds the engine, runs the traffic's first ``check_steps``
steps through the window's own call and feed, and is compared.

    python3 gnsbench/readings.py --workload products.train.gns \\
        --seeds 101-112 --control 3 --faults half_batch --fault-seeds 3

One JSON object a reading on standard output, and a summary at the end.
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def seeds(spec: str) -> list:
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch
    from gnsbench import data as gdata, faults, harness
    dev = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    ds = gdata.load_dataset(cell.workload["config"], cell.config["data"],
                            dev)
    t = cell.traffic
    probs = harness.cache_probs(ds, cell)
    kinds = [("program", s) for s in args.seeds]
    kinds += [(f, s) for f in filter(None, args.faults.split(","))
              for s in args.seeds[:args.fault_seeds]]
    out = {}
    for kind, seed in kinds:
        t0 = time.perf_counter()
        with (faults.FAULTS[kind]() if kind != "program"
              else contextlib.nullcontext()):
            _, weights, engine, rec = harness.setup(
                cell, seed, dev, ds=ds, warmup=t["check_steps"])
        del engine
        gc.collect()
        nums, detail = harness.check(ds, cell, weights, rec, dev,
                                        probs=probs)
        rows = [(kind, nums, detail)]
        if kind == "program" and args.seeds.index(seed) < args.control:
            ctl, cdet = harness.check(ds, cell, weights, rec, dev,
                                         tf32=True, probs=probs)
            rows.append(("control", ctl, cdet))
        for k, n, det in rows:
            print(json.dumps({"kind": k, "seed": seed, **n, **det,
                              "s": round(time.perf_counter() - t0, 3)}),
                  flush=True)
            for name, v in n.items():
                out.setdefault(k, {}).setdefault(name, []).append(v)
    for k, nums in out.items():
        print(json.dumps({"summary": k, **{n: [min(v), max(v)]
                                           for n, v in nums.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
