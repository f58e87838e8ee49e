"""Pass 4 — retrace hazards: the pad registry (the port's copy of the
``retrace-pad-registry`` rule of ``repro.analysis.retrace``).

``retrace-pad-registry``
    structural markers over the shape-padding sites that fixed kernel
    shapes rest on (and that a captured step per bucket will rest on).
    Each registry entry pins a function to a required source idiom; if a
    refactor drops the idiom (e.g. the power-of-two rounding in
    ``build_device_cache_adj``), the pass fails *here* instead of a
    serving run growing a new shape per refresh.

The reference's two scalar rules (``retrace-scalar-arg``,
``retrace-scalar-flow``) key on ``jax.jit`` roots; the port has no traced
or captured roots yet, so they are not ported.
"""
from __future__ import annotations

import ast
from typing import List, Tuple

from .common import RepoIndex, Violation

# (path-suffix, function-local-name, required-substring, reason)
PAD_REGISTRY: List[Tuple[str, str, str, str]] = [
    ("sampling/adjacency.py", "build_device_cache_adj", "bit_length",
     "DeviceCacheAdj capacity must stay power-of-two padded "
     "(fixed shapes across refreshes)"),
    ("serve/batcher.py", "MicroBatcher.bucket_for", "self.buckets",
     "serve batches must quantize to the fixed bucket ladder"),
    ("featurestore/store.py", "CacheConfig.size", "%",
     "cache size must stay quantized (shard-count multiple)"),
]


def run(index: RepoIndex) -> List[Violation]:
    out: List[Violation] = []
    for suffix, local, needle, reason in PAD_REGISTRY:
        hit_module = None
        for mi in index.modules.values():
            if mi.path.endswith(suffix):
                hit_module = mi
                break
        if hit_module is None:
            continue  # file moved: the baseline ratchet will catch churn
        fi = hit_module.functions.get(local)
        if fi is None:
            out.append(Violation(
                rule="retrace-pad-registry", path=hit_module.path, line=1,
                symbol=local,
                message=(f"pad-registry function `{local}` not found in "
                         f"{suffix} — {reason}"),
                detail=f"{local}:missing"))
            continue
        seg = ast.get_source_segment(
            "\n".join(hit_module.source_lines), fi.node)
        if seg is None:
            start = fi.node.lineno - 1
            end = getattr(fi.node, "end_lineno", start + 1)
            seg = "\n".join(hit_module.source_lines[start:end])
        if needle not in seg:
            out.append(Violation(
                rule="retrace-pad-registry", path=hit_module.path,
                line=fi.node.lineno, symbol=local,
                message=(f"`{local}` lost its `{needle}` padding idiom — "
                         f"{reason}"),
                detail=f"{local}:{needle}"))
    return out
