"""Pass 1 — trace purity (the port's copy of
``repro.analysis.trace_purity``).

Walks the call graph rooted at the port's trace roots (``TRACE_ROOTS`` in
``common.py``: the counterparts of every function the reference hands to
``jax.jit`` / ``shard_map`` / ``pallas_call``) and flags Python-side
nondeterminism or state inside that region.  The port runs these functions
eagerly, once per call; a captured step (a CUDA graph) runs their Python
once per capture and replays only the device work.  Everything the region
does must therefore be a pure function of its tensor or static inputs, or a
replay silently does something other than the eager call the tests
blessed.

Rules
-----
``trace-nondeterminism``
    ``random.*``, unseeded ``np.random.*``, ``time.*`` (incl. ``sleep``),
    ``datetime.now``/``utcnow``, ``uuid.*``, ``os.urandom`` anywhere in the
    traced call graph; and torch's global generator: ``torch.rand``/
    ``randn``/``randint``/``randperm``/``normal``/``bernoulli``/
    ``multinomial``/``poisson`` and the in-place ``uniform_``/``normal_``
    family without ``generator=``, and the ``*_like`` draws (which take
    none).
``trace-global-state``
    ``global`` / ``nonlocal`` declarations inside traced functions.
``trace-self-mutation``
    assignment / augmented-assignment to ``self.<attr>`` inside a traced
    method — it runs once per capture, not once per call.
``trace-mutation``
    mutating method calls (``append``/``update``/``pop``/``add``/...) on
    names not bound locally in the function — closed-over mutable state.
``trace-host-branch``
    ``if``/``while`` tests that name a ``"step"`` root's parameter which is
    not static (root functions only: deeper in the graph we can't tell
    tensors from Python values without type inference, and the root
    signature is where the hazard enters).
``trace-root-missing``
    a ``TRACE_ROOTS`` row whose file is there but whose function is gone.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from .common import (FuncInfo, ModuleInfo, RepoIndex, TraceRoot, Violation,
                     dotted, find_trace_roots, missing_trace_roots)

NONDET_CALLS = {
    "random.random", "random.randint", "random.randrange", "random.choice",
    "random.choices", "random.shuffle", "random.sample", "random.uniform",
    "random.gauss", "random.normalvariate", "random.getrandbits",
    "np.random.rand", "np.random.randn", "np.random.randint",
    "np.random.random", "np.random.choice", "np.random.permutation",
    "np.random.shuffle", "np.random.uniform", "np.random.normal",
    "numpy.random.rand", "numpy.random.randn", "numpy.random.randint",
    "numpy.random.random", "numpy.random.choice", "numpy.random.permutation",
    "time.time", "time.perf_counter", "time.monotonic", "time.sleep",
    "time.process_time", "time.time_ns", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "uuid.uuid4", "uuid.uuid1", "os.urandom",
    # torch draws that take no generator: always the global one
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
}

# torch draws from the global generator unless handed ``generator=``
TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
}
INPLACE_DRAWS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
}

MUTATING_METHODS = {
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "clear", "remove", "discard", "setdefault", "sort", "reverse",
}

# names whose use in a branch test never reads a tensor's value
_BRANCH_SAFE_CALLS = {"isinstance", "len", "hasattr", "getattr", "callable",
                      "issubclass", "type"}


def _local_bindings(fn: ast.AST) -> Set[str]:
    """Names bound inside the function (params, assigns, for, with, comps)."""
    out: Set[str] = set()
    node = fn
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = node.args
        for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            out.add(arg.arg)
        if a.vararg:
            out.add(a.vararg.arg)
        if a.kwarg:
            out.add(a.kwarg.arg)
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store,)):
            out.add(n.id)
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            for t in ast.walk(n.target):
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(n, ast.comprehension):
            for t in ast.walk(n.target):
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            for t in ast.walk(n.optional_vars):
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _root_param_names(fi: FuncInfo) -> List[str]:
    node = fi.node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    a = node.args
    names = [arg.arg for arg in (*a.posonlyargs, *a.args)]
    if names and names[0] == "self":
        names = names[1:]
    return names


def _branch_names(test: ast.AST) -> Set[str]:
    """Bare names read in a branch test, minus safe-call arguments and
    `x is None` patterns (shape/None dispatch is static by construction)."""
    skip: Set[int] = set()
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            fname = dotted(n.func)
            if fname in _BRANCH_SAFE_CALLS:
                for sub in ast.walk(n):
                    skip.add(id(sub))
        elif isinstance(n, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            for sub in ast.walk(n):
                skip.add(id(sub))
        elif isinstance(n, ast.Attribute):
            # obj.shape / obj.is_cuda / cfg.flag — attribute reads are
            # either static metadata or config, not a tensor-value read
            for sub in ast.walk(n):
                skip.add(id(sub))
    out: Set[str] = set()
    for n in ast.walk(test):
        if (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                and id(n) not in skip):
            out.add(n.id)
    return out


def _global_draw(node: ast.Call, d: str, norm: str) -> bool:
    """A torch draw from the global generator (no ``generator=``)."""
    if any(kw.arg == "generator" for kw in node.keywords):
        return False
    if d in TORCH_DRAWS or norm in TORCH_DRAWS:
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in INPLACE_DRAWS)


def _check_function(fi: FuncInfo, mi: ModuleInfo,
                    root: Optional[TraceRoot]) -> List[Violation]:
    out: List[Violation] = []
    fn = fi.node
    local = _local_bindings(fn)
    sym = fi.qualname.split(":", 1)[1]

    def emit(rule: str, line: int, msg: str, detail: str) -> None:
        if rule in mi.suppressed(line) or "*" in mi.suppressed(line):
            return
        out.append(Violation(rule=rule, path=mi.path, line=line,
                             symbol=sym, message=msg, detail=detail))

    for node in ast.walk(fn):
        # don't descend into nested defs here; they are separate graph nodes
        if node is not fn and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            emit("trace-global-state", node.lineno,
                 f"`{type(node).__name__.lower()} {', '.join(node.names)}` "
                 "inside a traced function runs once per capture, not once "
                 "per call",
                 ",".join(node.names))
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is None:
                continue
            # normalize through the import map's first component
            norm = d
            head = d.split(".")[0]
            imp = mi.imports.get(head)
            if imp is not None:
                norm = imp + d[len(head):]
            if d in NONDET_CALLS or norm in NONDET_CALLS \
                    or _global_draw(node, d, norm):
                emit("trace-nondeterminism", node.lineno,
                     f"call to nondeterministic `{d}` in traced code — use "
                     "the counter-based RNG (sampling/rng.py) or a seeded "
                     "`generator=`",
                     d)
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in MUTATING_METHODS
                  and isinstance(getattr(node, "_gns_parent", None),
                                 ast.Expr)):
                # result-discarded call: the stdlib mutators return None, so
                # a bare `x.update(...)` statement is mutation — while
                # `new = opt.update(...)` is the pure-functional idiom
                base = dotted(node.func.value)
                if base is not None and base.split(".")[0] not in local \
                        and not base.startswith("self."):
                    emit("trace-mutation", node.lineno,
                         f"mutating call `{d}()` on non-local `{base}` — "
                         "closed-over state in a traced region changes once "
                         "per capture, not once per call",
                         d)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                td = dotted(t)
                if td is not None and td.startswith("self.") \
                        and td.count(".") == 1:
                    emit("trace-self-mutation", node.lineno,
                         f"write to `{td}` inside traced code runs once per "
                         "capture, not once per call",
                         td)

    # host branching on non-static root params (step roots only)
    if root is not None and root.kind == "step":
        params = _root_param_names(fi)
        static = set(root.static_names)
        for i in root.static_nums:
            if 0 <= i < len(params):
                static.add(params[i])
        dyn = set(params) - static
        for node in ast.walk(fn):
            if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, (ast.If, ast.While)):
                hit = _branch_names(node.test) & dyn
                for name in sorted(hit):
                    emit("trace-host-branch", node.lineno,
                         f"`if {name}: ...` branches on step parameter "
                         f"`{name}` — a capture keeps the branch it took; "
                         "make it static or use `torch.where`",
                         name)
    return out


def run(index: RepoIndex,
        roots: Optional[Sequence[TraceRoot]] = None) -> List[Violation]:
    """The rules over the region of ``roots`` (default: the resolved
    ``TRACE_ROOTS`` rows, whose missing functions are findings too)."""
    out: List[Violation] = []
    if roots is None:
        roots = find_trace_roots(index)
        out.extend(missing_trace_roots(index))
    by_ref = {}
    for r in roots:
        by_ref.setdefault(r.ref, r)
    seen_keys: Set[str] = set()
    for ref in sorted(index.reachable([r.ref for r in roots])):
        fi = index.func(ref)
        if fi is None:
            continue
        for v in _check_function(fi, fi.module, by_ref.get(ref)):
            k = v.key() + f"@{v.line}"
            if k not in seen_keys:
                seen_keys.add(k)
                out.append(v)
    return out
