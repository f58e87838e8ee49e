"""Pass 3 — generation pinning (the port's copy of
``repro.analysis.generation``).

The feature store's cache flips atomically between :class:`Generation`
objects; a mini-batch must be assembled against exactly ONE generation
(pinned in ``MiniBatch.cache_gen``) or its importance weights (paper
eq. 11) tear across the swap.  The safe idiom is a single snapshot read::

    gen = store.generation          # one atomic property read
    ...use gen.cache_table / gen.device_adj / gen.version...

Rules
-----
``gen-chained-read``
    ``store.generation.<field>`` — the generation object is read and
    dereferenced in one expression; a second such chain in the same scope
    may observe a different generation.
``gen-multi-read``
    two or more loads of ``<obj>.generation`` in one function body —
    each read may return a different generation.
``gen-direct-private``
    any touch of ``._live`` / ``._shadow`` / ``._staging_owner`` outside
    ``featurestore/store.py`` — the double-buffer internals are not API.

Whitelisted: ``featurestore/store.py`` itself, plus accessor functions
whose whole job is the pinned read (``adopt_generation``, ``ensure_cache``,
``serving``).
"""
from __future__ import annotations

import ast
from typing import Dict, List

from .common import RepoIndex, Violation, dotted, parents

PRIVATE_ATTRS = {"_live", "_shadow", "_staging_owner"}
WHITELIST_PATHS = {"repro_torch/featurestore/store.py",
                   "featurestore/store.py"}
WHITELIST_FUNCS = {"adopt_generation", "ensure_cache", "serving"}


def _enclosing_func_name(node: ast.AST) -> str:
    for p in parents(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls = None
            for q in parents(p):
                if isinstance(q, ast.ClassDef):
                    cls = q.name
                    break
            return f"{cls}.{p.name}" if cls else p.name
    return "<module>"


def run(index: RepoIndex) -> List[Violation]:
    out: List[Violation] = []
    for mi in index.modules.values():
        if mi.path in WHITELIST_PATHS or mi.path.endswith(
                "featurestore/store.py"):
            continue
        # per-function count of `X.generation` loads
        gen_reads: Dict[str, List[ast.Attribute]] = {}
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Attribute):
                continue
            sym = _enclosing_func_name(node)
            if sym.split(".")[-1] in WHITELIST_FUNCS:
                continue
            sup = mi.suppressed(node.lineno)
            # --- private double-buffer internals --------------------------
            if node.attr in PRIVATE_ATTRS and isinstance(node.ctx,
                                                         (ast.Load,
                                                          ast.Store)):
                base = dotted(node.value)
                # only flag when the base smells like a store, to avoid
                # colliding with unrelated `_shadow` attrs in other classes
                if base is not None and ("store" in base.lower()
                                         or base == "self.store"):
                    if "gen-direct-private" not in sup and "*" not in sup:
                        out.append(Violation(
                            rule="gen-direct-private", path=mi.path,
                            line=node.lineno, symbol=sym,
                            message=(f"`{base}.{node.attr}` touches the "
                                     "store's double-buffer internals — use "
                                     "`generation` / `swap_if_ready()`"),
                            detail=f"{base}.{node.attr}"))
                continue
            if node.attr != "generation" or not isinstance(node.ctx,
                                                           ast.Load):
                continue
            # --- chained read: X.generation.Y -----------------------------
            parent = getattr(node, "_gns_parent", None)
            if isinstance(parent, ast.Attribute) and parent.value is node:
                if "gen-chained-read" not in sup and "*" not in sup:
                    base = dotted(node.value) or "<expr>"
                    out.append(Violation(
                        rule="gen-chained-read", path=mi.path,
                        line=node.lineno, symbol=sym,
                        message=(f"`{base}.generation.{parent.attr}` "
                                 "dereferences an unpinned generation — "
                                 "snapshot it first: `gen = "
                                 f"{base}.generation`"),
                        detail=f"{base}.generation.{parent.attr}"))
            # --- collect for multi-read (chained reads count too) ----------
            base = dotted(node.value)
            if base is None:
                continue
            key = f"{sym}|{base}"
            gen_reads.setdefault(key, []).append(node)
        for key, nodes in gen_reads.items():
            if len(nodes) < 2:
                continue
            sym, base = key.split("|", 1)
            first = nodes[1]  # report at the second read
            sup = mi.suppressed(first.lineno)
            if "gen-multi-read" in sup or "*" in sup:
                continue
            out.append(Violation(
                rule="gen-multi-read", path=mi.path, line=first.lineno,
                symbol=sym,
                message=(f"{len(nodes)} reads of `{base}.generation` in one "
                         "function — each may observe a different "
                         "generation; snapshot once"),
                detail=f"{base}.generation"))
    return out
