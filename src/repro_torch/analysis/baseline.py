"""Baseline ratchet — same contract as the coverage floor, for findings
(the port's copy of ``repro.analysis.baseline``).

The checked-in baseline is the set of consciously-tolerated violation keys
(line-number-free: ``rule|path|symbol|detail``, with ``#N`` suffixes for
repeats), the reference's format: either package's :func:`compare` reads
the other's file alike.  Comparison is two-sided:

* a violation NOT in the baseline is **new** → fail (the pass tightens);
* a baseline entry with no matching violation is **stale** → fail (the file
  may only shrink; fixing a violation must delete its entry, so the ratchet
  can't silently slacken).

``--write-baseline`` regenerates the file from the current findings.
Warnings are never baselined — they don't affect the exit code.
"""
from __future__ import annotations

import collections
from pathlib import Path
from typing import Dict, List, Tuple

from .common import Violation

HEADER = (
    "# gnscheck baseline — consciously tolerated violations.\n"
    "# This file is a ratchet: entries may be REMOVED (by fixing the\n"
    "# violation), never added. New violations fail CI; stale entries\n"
    "# fail CI. Regenerate with: python -m repro_torch.analysis\n"
    "# --baseline .github/gnscheck-torch-baseline.txt --write-baseline\n")


def keyed(violations: List[Violation]) -> List[str]:
    """Stable keys with #N disambiguation for identical repeats."""
    counts: Dict[str, int] = collections.Counter()
    out: List[str] = []
    for v in violations:
        if v.severity == "warning":
            continue
        k = v.key()
        counts[k] += 1
        out.append(k if counts[k] == 1 else f"{k}#{counts[k]}")
    return out


def load(path: Path) -> List[str]:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.append(line)
    return out


def write(path: Path, violations: List[Violation]) -> int:
    keys = sorted(keyed(violations))
    path.write_text(HEADER + "".join(k + "\n" for k in keys))
    return len(keys)


def compare(violations: List[Violation], baseline: List[str]
            ) -> Tuple[List[Violation], List[str]]:
    """-> (new_violations, stale_baseline_entries)."""
    current = keyed(violations)
    base_set = set(baseline)
    cur_set = set(current)
    new = []
    counts: Dict[str, int] = collections.Counter()
    for v in violations:
        if v.severity == "warning":
            continue
        k = v.key()
        counts[k] += 1
        kk = k if counts[k] == 1 else f"{k}#{counts[k]}"
        if kk not in base_set:
            new.append(v)
    stale = sorted(base_set - cur_set)
    return new, stale
