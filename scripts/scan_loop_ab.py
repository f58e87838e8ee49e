#!/usr/bin/env python3
"""The layer loop's two forms on one CUDA card: a decode-step A/B.

    PYTHONPATH=src python3 scripts/scan_loop_ab.py [--steps 30] [--rounds 8]

Run from the root of a checkout on a host with a CUDA card.  It builds
``h2o-danube-3-4b`` at its published width (random weights from seed 0)
and a 2-request decode state whose 4,096-slot ring wraps in every round,
then times ``lm_decode_step`` under ``torch.inference_mode`` with the two
forms of ``scan_util.scan``'s layer loop: ``unbind`` (one
``torch.unbind`` per stacked leaf, the port's form) and ``views``
(``leaf[i]`` per layer and leaf).  Rounds run in the order A B B A,
repeated, each ``--steps`` steps between two synchronisations of the
card, so that drift of the host's clock falls on both forms alike.  First the two forms are
held to each other on one step from equal states: the logits and every
written cache row must be equal bit for bit.  One ``[scan-ab]`` line per
round, a ``[scan-ab-summary]`` line with the median ms per step of each
form, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PROMPT = 4080           # each round starts here: the ring wraps at step 16


def views(tree):
    from repro_torch.models import scan_util
    n = scan_util.tree_leaves(tree)[0].shape[0]
    return [scan_util.tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_loop_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import scan_util, transformer
    from repro_torch.models.lm import get_model
    forms = {"unbind": scan_util._unbind_layers, "views": views}
    cfg = get_config("h2o-danube-3-4b")
    dev = torch.device("cuda")
    params = get_model(cfg).init(0)
    state = transformer.init_decode_state(cfg, 2, cfg.sliding_window + 64,
                                          device=dev)
    state["pos"] = PROMPT
    tokens = torch.ones((2, 1), dtype=torch.int32, device=dev)

    def run(form, st, steps):
        scan_util._unbind_layers = forms[form]
        try:
            for _ in range(steps):
                logits, st = transformer.lm_decode_step(params, cfg, tokens,
                                                        st)
        finally:
            scan_util._unbind_layers = forms["unbind"]
        return logits, st

    def clone(st):
        return {"caches": scan_util.tree_map(torch.clone, st["caches"]),
                "pos": st["pos"]}

    with torch.inference_mode():
        out = {f: run(f, clone(state), 1) for f in forms}
        equal = torch.equal(out["unbind"][0], out["views"][0]) and all(
            torch.equal(a, b) for a, b in zip(
                scan_util.tree_leaves(out["unbind"][1]["caches"]),
                scan_util.tree_leaves(out["views"][1]["caches"])))
        print(f"[scan-ab-check] logits_and_caches_equal={equal}", flush=True)
        if not equal:
            return 1
        del out
        times = {f: [] for f in forms}
        order = ["unbind", "views", "views", "unbind"]
        for r in range(args.rounds):
            form = order[r % 4]
            st = clone(state)
            run(form, st, 2)                                  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = run(form, st, args.steps)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / args.steps
            times[form].append(ms)
            print(f"[scan-ab] round={r} form={form} steps={args.steps} "
                  f"ms_per_step={ms:.3f}", flush=True)
            del st
    med = {f: round(statistics.median(v), 3) for f, v in times.items() if v}
    print(f"[scan-ab-summary] arch={cfg.name} batch=2 layers={cfg.num_layers}"
          f" median_ms_per_step={med}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else
          torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
