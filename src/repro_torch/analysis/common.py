"""Shared infrastructure for the port's ``gnscheck`` static passes (the
port's own copy of ``repro.analysis.common``; it never imports ``repro``).

Everything here is plain-``ast`` and stdlib-only: the analyzer parses the
package, it never imports it, so a host without ``torch`` (or with a broken
one) can still run the checks.

Provided:

* :class:`Violation` — one finding, with a line-number-free :meth:`key` so
  the baseline survives unrelated edits (see ``baseline.py``).  Keys have
  the reference's ``rule|path|symbol|detail`` format, so either package's
  baseline reads the other's file alike.
* :class:`RepoIndex` — every module parsed once, parent links attached, with
  per-module import maps, function/class tables, and a cheap call graph
  (module functions, ``self.`` methods, direct imports, ``Cls.apply`` of a
  ``torch.autograd.Function`` to its ``forward``/``backward``, and a
  unique-name fallback for attribute calls).
* :data:`TRACE_ROOTS` and :func:`find_trace_roots` — the port's
  counterparts of the reference's traced entry points (the functions it
  hands to ``jax.jit`` / ``shard_map`` / ``pallas_call``), with their
  static parameters: the shared entry-point table of the trace-purity and
  retrace passes.  The port traces nothing; these are the eager functions
  that do the same work once per call, and that a captured step would
  capture.
* ``# gnscheck: ignore[rule]`` line suppressions.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*gnscheck:\s*ignore\[([a-z0-9_,\- ]+)\]")
AUTOGRAD_FUNCTION = "torch.autograd.Function"


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str                # repo-relative, '/'-separated
    line: int
    symbol: str              # dotted qualname of the enclosing def/class
    message: str
    detail: str = ""         # stable discriminator (attr name, callee, ...)
    severity: str = "error"  # "error" | "warning"

    def key(self) -> str:
        """Line-number-free identity used by the baseline ratchet."""
        return f"{self.rule}|{self.path}|{self.symbol}|{self.detail}"

    def render(self) -> str:
        tag = "warning" if self.severity == "warning" else "error"
        return (f"{self.path}:{self.line}: [{self.rule}] {tag}: "
                f"{self.message} ({self.symbol})")


def attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._gns_parent = node  # type: ignore[attr-defined]


def parents(node: ast.AST) -> Iterable[ast.AST]:
    cur = getattr(node, "_gns_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_gns_parent", None)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FuncInfo:
    qualname: str            # "pkg.mod:Class.method" / "pkg.mod:fn.inner"
    node: ast.AST            # FunctionDef | AsyncFunctionDef | Lambda
    module: "ModuleInfo"
    cls: Optional[str]       # enclosing class name, if a method

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1].rsplit(":", 1)[-1]


@dataclasses.dataclass
class ModuleInfo:
    name: str                # dotted module name
                             # ("repro_torch.featurestore.store")
    path: str                # repo-relative path
    tree: ast.Module
    source_lines: List[str]
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
                             # local alias -> dotted target ("np" -> "numpy",
                             # "dist" -> "torch.distributed")
    functions: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
                             # local qualname ("Class.method", "fn") -> info
    classes: Dict[str, ast.ClassDef] = dataclasses.field(
        default_factory=dict)  # local qualname ("Outer.Inner") -> node

    def suppressed(self, line: int) -> Set[str]:
        if 1 <= line <= len(self.source_lines):
            m = SUPPRESS_RE.search(self.source_lines[line - 1])
            if m:
                return {r.strip() for r in m.group(1).split(",")}
        return set()


class RepoIndex:
    """All modules under ``root`` parsed, indexed, and cross-linked."""

    def __init__(self, root: Path, package_prefix: str = "repro_torch"):
        self.root = Path(root)
        self.modules: Dict[str, ModuleInfo] = {}      # dotted name -> info
        self.by_path: Dict[str, ModuleInfo] = {}
        # bare function/method name -> [qualified "mod:local" names]
        self.methods_by_name: Dict[str, List[str]] = {}
        prefix = package_prefix
        for py in sorted(self.root.rglob("*.py")):
            rel = py.relative_to(self.root)
            mod_name = ".".join((prefix, *rel.with_suffix("").parts)) \
                if str(rel) != "__init__.py" else prefix
            if rel.name == "__init__.py":
                mod_name = ".".join((prefix, *rel.parent.parts)) \
                    if rel.parent.parts else prefix
            try:
                src = py.read_text()
                tree = ast.parse(src)
            except (SyntaxError, UnicodeDecodeError):
                continue
            attach_parents(tree)
            mi = ModuleInfo(name=mod_name, path=str(rel).replace("\\", "/"),
                            tree=tree, source_lines=src.splitlines())
            self._index_imports(mi)
            self._index_functions(mi)
            self.modules[mod_name] = mi
            self.by_path[mi.path] = mi
        for mi in self.modules.values():
            for local, fi in mi.functions.items():
                self.methods_by_name.setdefault(fi.name, []).append(
                    f"{mi.name}:{local}")

    # ------------------------------------------------------------------
    @staticmethod
    def _index_imports(mi: ModuleInfo) -> None:
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mi.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name == "*":
                        continue
                    mi.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def _index_functions(self, mi: ModuleInfo) -> None:
        def visit(node: ast.AST, scope: Tuple[str, ...],
                  cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    local = ".".join((*scope, child.name))
                    mi.functions[local] = FuncInfo(
                        qualname=f"{mi.name}:{local}", node=child,
                        module=mi, cls=cls)
                    visit(child, (*scope, child.name), cls)
                elif isinstance(child, ast.ClassDef):
                    mi.classes[".".join((*scope, child.name))] = child
                    visit(child, (*scope, child.name), child.name)
                else:
                    visit(child, scope, cls)

        visit(mi.tree, (), None)

    # ------------------------------------------------------------------
    def resolve(self, mi: ModuleInfo, target: str) -> Optional[str]:
        """Resolve a dotted reference in ``mi``'s scope to "mod:local"."""
        head, _, rest = target.partition(".")
        # alias of an imported module / name
        imp = mi.imports.get(head)
        if imp is not None:
            target = f"{imp}.{rest}" if rest else imp
            # longest-prefix module match
            parts = target.split(".")
            for cut in range(len(parts) - 1, 0, -1):
                mod = ".".join(parts[:cut])
                if mod in self.modules:
                    local = ".".join(parts[cut:])
                    if local in self.modules[mod].functions:
                        return f"{mod}:{local}"
                    return None
            return None
        # module-local function (possibly Class.method)
        if target in mi.functions:
            return f"{mi.name}:{target}"
        return None

    def autograd_function(self, mi: ModuleInfo, target: str
                          ) -> Optional[str]:
        """"mod:Cls" if ``target`` names, in ``mi``'s scope, a subclass of
        ``torch.autograd.Function``, else None."""
        owner, local = mi, target
        head, _, rest = target.partition(".")
        imp = mi.imports.get(head)
        if imp is not None:
            parts = (f"{imp}.{rest}" if rest else imp).split(".")
            for cut in range(len(parts) - 1, 0, -1):
                mod = ".".join(parts[:cut])
                if mod in self.modules:
                    owner, local = self.modules[mod], ".".join(parts[cut:])
                    break
            else:
                return None
        node = owner.classes.get(local)
        for base in (node.bases if node is not None else ()):
            d = dotted(base)
            if d is None:
                continue
            head = d.split(".")[0]
            if owner.imports.get(head, head) + d[len(head):] == \
                    AUTOGRAD_FUNCTION:
                return f"{owner.name}:{local}"
        return None

    def func(self, ref: str) -> Optional[FuncInfo]:
        mod, _, local = ref.partition(":")
        mi = self.modules.get(mod)
        return mi.functions.get(local) if mi else None

    # ------------------------------------------------------------------
    def callees(self, ref: str, unique_name_fallback: bool = False
                ) -> Set[str]:
        """Outgoing call/reference edges of one function (best effort).

        Catches direct calls, ``self.`` method calls, and bare *references*
        to repo functions (higher-order use: ``grad(loss_fn)``, thread
        targets, scan bodies).  With ``unique_name_fallback``, an attribute
        call on an unknown object resolves iff exactly one class in the repo
        defines that method name (over-approximation used by thread
        reachability, not by trace purity).
        """
        fi = self.func(ref)
        if fi is None:
            return set()
        mi = fi.module
        out: Set[str] = set()
        own_scope = ref.split(":", 1)[1]
        for node in ast.walk(fi.node):
            d = None
            if isinstance(node, (ast.Name, ast.Attribute)) \
                    and isinstance(getattr(node, "ctx", None), ast.Load):
                d = dotted(node)
            if not d:
                continue
            if d.startswith("self."):
                # method of the enclosing class
                meth = d[len("self."):]
                if "." in meth:
                    continue
                if fi.cls:
                    local = f"{fi.cls}.{meth}"
                    if local in mi.functions:
                        out.add(f"{mi.name}:{local}")
                continue
            r = self.resolve(mi, d)
            if r is not None and r != ref:
                out.add(r)
                continue
            if d.endswith(".apply"):
                # Fn.apply(...) runs Fn.forward now and Fn.backward in the
                # backward pass: both belong to the caller's region
                cls = self.autograd_function(mi, d[:-len(".apply")])
                if cls is not None:
                    mod, _, local = cls.partition(":")
                    for meth in ("forward", "backward"):
                        if f"{local}.{meth}" in self.modules[mod].functions:
                            out.add(f"{cls}.{meth}")
                    continue
            if unique_name_fallback and "." in d:
                # over-approximate dynamic dispatch: a few same-named repo
                # methods (e.g. the policy registry's `scores`) all become
                # edges; a cap keeps pervasive names (`get`, `update`) from
                # connecting everything to everything
                name = d.rsplit(".", 1)[-1]
                cands = [c for c in self.methods_by_name.get(name, ())
                         if ":" in c and "." in c.split(":", 1)[1]]
                if 1 <= len(cands) <= 8:
                    out.update(cands)
        # nested defs are implicitly reachable from their parent (closures)
        for local, other in mi.functions.items():
            if local.startswith(own_scope + ".") and \
                    "." not in local[len(own_scope) + 1:]:
                out.add(f"{mi.name}:{local}")
        return out

    def reachable(self, roots: Iterable[str],
                  unique_name_fallback: bool = False) -> Set[str]:
        seen: Set[str] = set()
        stack = [r for r in roots]
        while stack:
            ref = stack.pop()
            if ref in seen:
                continue
            seen.add(ref)
            stack.extend(self.callees(
                ref, unique_name_fallback=unique_name_fallback))
        return seen


# ---------------------------------------------------------------------------
# the port's trace roots (shared by trace_purity and retrace)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceRoot:
    ref: str                     # "mod:local"
    kind: str                    # "step" | "kernel" | "rank"
    site_path: str
    site_line: int
    static_names: Set[str] = dataclasses.field(default_factory=set)
    static_nums: Set[int] = dataclasses.field(default_factory=set)


# The port's counterpart of every function the reference hands to
# ``jax.jit`` ("step"), ``pallas_call`` ("kernel": the CUDA launch wrapper)
# or ``shard_map`` ("rank": the per-rank function), one row per reference
# root: (path-suffix, function-local-name, kind, static parameter names,
# reference root).  The static names are the reference's static_argnames
# that the port's function has as parameters.
TRACE_ROOTS: List[Tuple[str, str, str, Tuple[str, ...], str]] = [
    ("gns/engine.py", "make_train_step.train_step", "step", (),
     "repro.gns.engine:make_train_step.train_step"),
    # describe_lowering counts the engine's own train step: the reference
    # wraps it only to drop `acc` from its out_shardings
    ("gns/engine.py", "make_train_step.train_step", "step", (),
     "repro.gns.describe:describe_lowering.train_step"),
    # what infer_compute and evaluate run: their _put_batch is the host
    # copy, which the reference keeps outside its jit
    ("models/graphsage.py", "forward", "step", (),
     "repro.gns.engine:GNSEngine.__init__.logits_step"),
    ("models/graphsage.py", "loss_fn", "step", (),
     "repro.gns.engine:GNSEngine.__init__.eval_step"),
    ("kernels/ops.py", "gather_agg", "step", (),
     "repro.kernels.ops:gather_agg"),
    ("kernels/ops.py", "cache_lookup_agg", "step",
     ("local_shard", "mesh", "shard_axis"),
     "repro.kernels.ops:cache_lookup_agg"),
    ("kernels/ops.py", "flash_attention", "step",
     ("causal", "scale", "window"), "repro.kernels.ops:flash_attention"),
    ("kernels/ops.py", "_sharded_forward", "rank", (),
     "repro.kernels.ops:_fused_forward.body"),
    ("kernels/ops.py", "_CacheLookupAgg.backward", "rank", (),
     "repro.kernels.ops:_fused_bwd.body"),
    ("launch/steps.py", "make_train_step.train_step", "step", (),
     "repro.launch.steps:make_train_step.train_step"),
    ("launch/steps.py", "make_serve_step.serve_step", "step", (),
     "repro.launch.steps:make_serve_step.serve_step"),
    ("launch/steps.py", "make_prefill_step.prefill_step", "step", (),
     "repro.launch.steps:make_prefill_step.prefill_step"),
    ("launch/serve.py", "ServeEngine._step", "step", (),
     "repro.launch.serve:ServeEngine._decode_fn.step"),
    ("models/attention.py", "sharded_attention", "rank", (),
     "repro.models.attention:sharded_attention.body"),
    ("models/moe.py", "moe_forward", "rank", (),
     "repro.models.moe:moe_forward.body"),
    ("sampling/kernels.py", "gns_sample_agg", "step", ("mesh", "shard_axis"),
     "repro.sampling.kernels:gns_sample_agg"),
    ("sampling/kernels.py", "gns_sample_agg", "rank", (),
     "repro.sampling.kernels:gns_sample_agg.body"),
    ("kernels/cache_lookup.py", "cache_lookup_agg_cuda", "kernel", (),
     "repro.kernels.cache_lookup:_kernel"),
    ("sampling/kernels.py", "gns_sample_agg_cuda", "kernel", (),
     "repro.sampling.kernels:_kernel"),
]


def module_at(index: RepoIndex, suffix: str) -> Optional[ModuleInfo]:
    """The first module whose path ends with ``suffix`` (a registry row's
    file), if any."""
    for mi in index.modules.values():
        if mi.path.endswith(suffix):
            return mi
    return None


def find_trace_roots(index: RepoIndex, table=TRACE_ROOTS) -> List[TraceRoot]:
    """The rows of ``table`` whose function is in ``index``.  A row whose
    file is not there is skipped (a scan root holding part of the tree); a
    row whose file is there but its function is not is
    :func:`missing_trace_roots`'s."""
    roots: List[TraceRoot] = []
    for suffix, local, kind, static, _ref in table:
        mi = module_at(index, suffix)
        fi = mi.functions.get(local) if mi is not None else None
        if fi is not None:
            roots.append(TraceRoot(
                ref=fi.qualname, kind=kind, site_path=mi.path,
                site_line=fi.node.lineno, static_names=set(static)))
    return roots


def missing_trace_roots(index: RepoIndex, table=TRACE_ROOTS
                        ) -> List[Violation]:
    """``trace-root-missing``: a row's file is there, its function is
    gone, so the passes would silently stop walking what it reached."""
    out: List[Violation] = []
    for suffix, local, _kind, _static, ref in table:
        mi = module_at(index, suffix)
        if mi is None or local in mi.functions:
            continue
        out.append(Violation(
            rule="trace-root-missing", path=mi.path, line=1, symbol=local,
            message=(f"trace root `{local}` (standing for the reference's "
                     f"`{ref}`) not found in {suffix} — update "
                     "TRACE_ROOTS"),
            detail=f"{local}:missing"))
    return out
