"""Command line: ``python -m repro_torch.analysis`` (the port's ``gnscheck``).

Runs trace purity, lock discipline, generation pinning, the retrace
rules (scalar arguments and flows, the pad registry) and the TrafficMeter
pairing lint over ``src/repro_torch`` (or ``--root``), in the reference's
order.

Exit codes: 0 clean (or all violations baselined), 1 new violations or
stale baseline entries (ratchet breach), 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

from .common import RepoIndex, Violation


def run_passes(index: RepoIndex) -> List[Violation]:
    # imported lazily so `import repro_torch.analysis` stays cheap for the
    # runtime-annotation consumers
    from . import generation, locks, meterlint, retrace, trace_purity
    out: List[Violation] = []
    for mod in (trace_purity, locks, generation, retrace, meterlint):
        out.extend(mod.run(index))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def stats(index: RepoIndex) -> Dict[str, int]:
    """What the passes walked: modules, ``@guarded_by`` classes, thread
    entry points, host→device transfer sites (paired or not), the
    ``TRACE_ROOTS`` rows that resolved and the functions they reach."""
    from . import locks, meterlint
    from .common import find_trace_roots
    transfers = meterlint.find_transfers(index)
    roots = find_trace_roots(index)
    return {
        "modules": len(index.modules),
        "guarded_classes": len(locks._parse_guarded(index)),
        "thread_entries": len(locks._thread_entry_refs(index)),
        "transfers": len(transfers),
        "paired_transfers": sum(t.paired for t in transfers),
        "trace_roots": len(roots),
        "traced_functions": len(index.reachable([r.ref for r in roots])),
    }


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnscheck",
        description="static analysis of the PyTorch port: trace purity, "
                    "lock discipline, generation pinning, retrace "
                    "hazards, TrafficMeter pairing")
    ap.add_argument("--root", default=None,
                    help="scan root (default: the repro_torch package this "
                         "module was imported from)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file; findings resolve against it "
                         "(new violation OR stale entry -> exit 1)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate --baseline from current findings")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--strict-warnings", action="store_true",
                    help="warnings also affect the exit code")
    args = ap.parse_args(argv)

    if args.root is not None:
        root = Path(args.root)
        prefix = root.name
    else:
        root = Path(__file__).resolve().parents[1]   # .../src/repro_torch
        prefix = "repro_torch"
    if not root.is_dir():
        print(f"gnscheck: scan root {root} is not a directory",
              file=sys.stderr)
        return 2

    index = RepoIndex(root, package_prefix=prefix)
    violations = run_passes(index)
    errors = [v for v in violations if v.severity != "warning"]
    warnings = [v for v in violations if v.severity == "warning"]

    from . import baseline as bl

    if args.write_baseline:
        if not args.baseline:
            print("gnscheck: --write-baseline requires --baseline",
                  file=sys.stderr)
            return 2
        n = bl.write(Path(args.baseline), violations)
        print(f"gnscheck: wrote {n} baseline entries to {args.baseline}")
        for v in warnings:
            print(v.render())
        return 0

    new, stale = (errors, [])
    if args.baseline:
        new, stale = bl.compare(violations, bl.load(Path(args.baseline)))

    if args.as_json:
        print(json.dumps({
            "violations": [vars(v) for v in violations],
            "new": [vars(v) for v in new],
            "stale_baseline": stale,
            "stats": stats(index),
        }, indent=2, default=str))
    else:
        for v in violations:
            baselined = args.baseline and v.severity != "warning" \
                and v not in new
            suffix = "  [baselined]" if baselined else ""
            print(v.render() + suffix)
        for k in stale:
            print(f"baseline: stale entry (violation fixed but not removed "
                  f"from baseline): {k}")
        n_base = len(errors) - len(new)
        print(f"gnscheck: {len(errors)} error(s) "
              f"({len(new)} new, {n_base} baselined), "
              f"{len(warnings)} warning(s), {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'}")

    failed = bool(new) or bool(stale)
    if args.strict_warnings and warnings:
        failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
