"""Run one cell of the benchmark of the PyTorch/CUDA port, once.

    python3 gnsbench/run.py --workload products.train.gns --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result, one JSON object;
the last lines of standard error compare each checked number with its
limit.  It exits with a non-zero code, and prints no result, without a
CUDA card, or if the run loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()     # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# the program's caches stay inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from gnsbench import harness
    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda:0",
                                     t_start=T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
