"""Pass 4 — retrace hazards (the port's copy of
``repro.analysis.retrace``).

The port traces nothing yet; a captured step (a CUDA graph, one per
bucket) is keyed on its shapes and on the Python values its code branched
on, as ``jax.jit`` is.  These rules guard the same property on the port's
trace roots (``TRACE_ROOTS`` in ``common.py``):

``retrace-scalar-arg``
    a ``"step"`` root whose parameter is annotated / defaulted as a Python
    scalar (``int``/``bool``/``str``) but is not static.  Every new value
    of such a parameter is a potential new capture.
``retrace-scalar-flow``
    ``len(...)`` / ``int(...)`` / ``.item()`` expressions used directly as
    positional arguments at a call site whose callee resolves to a trace
    root — runtime-derived scalars entering a traced signature.  (The
    reference matches the callee's bare name, and names bound from
    ``jax.jit``; the port has no such bindings, and a bare name would take
    every ``.forward(``.)
``retrace-pad-registry``
    structural markers over the shape-padding sites that fixed kernel
    shapes rest on (and that a captured step per bucket will rest on).
    Each registry entry pins a function to a required source idiom; if a
    refactor drops the idiom (e.g. the power-of-two rounding in
    ``build_device_cache_adj``), the pass fails *here* instead of a
    serving run growing a new shape per refresh.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set, Tuple

from .common import (RepoIndex, TraceRoot, Violation, dotted,
                     find_trace_roots, module_at, parents)

SCALAR_ANNOTS = {"int", "bool", "str"}   # float params are usually tensor
                                         # weights (lr, temp) — exempt

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


def _scalar_annotation(arg: ast.arg) -> Optional[str]:
    a = arg.annotation
    if a is None:
        return None
    d = dotted(a)
    if d in SCALAR_ANNOTS:
        return d
    # Optional[int] / int | None
    if isinstance(a, ast.Subscript) and dotted(a.value) in ("Optional",
                                                            "typing.Optional"):
        inner = dotted(a.slice)
        if inner in SCALAR_ANNOTS:
            return inner
    if isinstance(a, ast.BinOp) and isinstance(a.op, ast.BitOr):
        for side in (a.left, a.right):
            d = dotted(side)
            if d in SCALAR_ANNOTS:
                return d
    return None


def _scalar_default(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value,
                                                     (int, bool, str)):
        return type(node.value).__name__
    return None


def _scalar_args(index: RepoIndex,
                 roots: Sequence[TraceRoot]) -> List[Violation]:
    out: List[Violation] = []
    seen: Set[str] = set()
    for root in roots:
        if root.kind != "step":
            continue  # kernel/rank roots have their own argument regimes
        fi = index.func(root.ref)
        if fi is None or not isinstance(fi.node, (ast.FunctionDef,
                                                  ast.AsyncFunctionDef)):
            continue
        mi = fi.module
        sym = fi.qualname.split(":", 1)[1]
        a = fi.node.args
        params = [*a.posonlyargs, *a.args]
        names = [p.arg for p in params]
        if names and names[0] == "self":
            params, names = params[1:], names[1:]
        static = set(root.static_names)
        for i in root.static_nums:
            if 0 <= i < len(names):
                static.add(names[i])
        # defaults align to the tail of params
        defaults: List[Optional[ast.AST]] = \
            [None] * (len(params) - len(a.defaults)) + list(a.defaults)
        for p, dflt in zip(params, defaults):
            if p.arg in static:
                continue
            why = _scalar_annotation(p)
            if why is None and dflt is not None:
                why = _scalar_default(dflt)
            if why is None:
                continue
            key = f"{root.ref}:{p.arg}"
            if key in seen:
                continue
            seen.add(key)
            sup = mi.suppressed(p.lineno)
            if "retrace-scalar-arg" in sup or "*" in sup:
                continue
            out.append(Violation(
                rule="retrace-scalar-arg", path=mi.path, line=p.lineno,
                symbol=sym,
                message=(f"step parameter `{p.arg}: {why}` is not static — "
                         "every new value is a potential new capture; make "
                         "it static or pass a tensor"),
                detail=p.arg))
    return out


def _enclosing_symbol(node: ast.AST) -> str:
    for p in parents(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for q in parents(p):
                if isinstance(q, ast.ClassDef):
                    return f"{q.name}.{p.name}"
            return p.name
    return "<module>"


def _callee(index: RepoIndex, mi, node: ast.Call, d: str) -> Optional[str]:
    """The repo function a call site calls, where it can tell."""
    if d.startswith("self.") and d.count(".") == 1:
        for p in parents(node):
            if isinstance(p, ast.ClassDef):
                local = f"{p.name}.{d[len('self.'):]}"
                return f"{mi.name}:{local}" if local in mi.functions else None
        return None
    return index.resolve(mi, d)


def _scalar_flows(index: RepoIndex,
                  roots: Sequence[TraceRoot]) -> List[Violation]:
    out: List[Violation] = []
    root_refs = {r.ref for r in roots}
    for mi in index.modules.values():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d is None or _callee(index, mi, node, d) not in root_refs:
                continue
            for arg in node.args:
                bad = None
                if isinstance(arg, ast.Call):
                    ad = dotted(arg.func)
                    if ad in ("len", "int"):
                        bad = f"{ad}(...)"
                    elif isinstance(arg.func, ast.Attribute) \
                            and arg.func.attr == "item":
                        bad = ".item()"
                if bad is None:
                    continue
                sup = mi.suppressed(node.lineno)
                if "retrace-scalar-flow" in sup or "*" in sup:
                    continue
                out.append(Violation(
                    rule="retrace-scalar-flow", path=mi.path,
                    line=node.lineno, symbol=_enclosing_symbol(node),
                    message=(f"runtime scalar `{bad}` flows positionally "
                             f"into traced `{d}` — pad to a static shape "
                             "or make the parameter static"),
                    detail=f"{d.split('.')[-1]}:{bad}"))
    return out


def run(index: RepoIndex,
        roots: Optional[Sequence[TraceRoot]] = None) -> List[Violation]:
    """The scalar rules over ``roots`` (default: the resolved
    ``TRACE_ROOTS`` rows), then the pad registry."""
    if roots is None:
        roots = find_trace_roots(index)
    out = _scalar_args(index, roots) + _scalar_flows(index, roots)
    for suffix, local, needle, reason in PAD_REGISTRY:
        hit_module = module_at(index, suffix)
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
