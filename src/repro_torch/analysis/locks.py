"""Pass 2 — lock discipline (the port's copy of ``repro.analysis.locks``).

Reads the ``@guarded_by(...)`` registry (see
``repro_torch.analysis.runtime``) off class decorators and proves, per
annotated class, that every read/write of a guarded attribute is dominated
by ``with self.<lock>`` — but only for code that can actually race:
methods reachable from a ``threading.Thread(target=...)`` entry point, or
from public methods of a class that owns such a thread (the client-facing
half of the race).

Rules
-----
``lock-unguarded-write``
    ``self.<attr> = ...`` outside ``with self.<lock>`` for a guarded attr.
``lock-unguarded-read``
    a load of a read/write-guarded attr outside the lock.
``lock-external-access``
    ``obj.<attr>`` where ``obj`` is an instance of an annotated class and
    the access is not under ``with obj.<lock>`` (same base expression).
    The reference documents this rule but reports such a finding as
    ``lock-unguarded-read``/``-write``; the port reports it under its
    own name (its detail, ``obj.<attr>``, is the reference's).

``__init__`` is exempt (construction happens-before publication).  Methods
decorated ``@holds_lock("<lock>")`` are treated as lock-dominated bodies.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .common import ModuleInfo, RepoIndex, Violation, dotted, parents


@dataclasses.dataclass
class GuardedClass:
    module: ModuleInfo
    cls_name: str
    node: ast.ClassDef
    lock_of: Dict[str, Tuple[str, str]]   # attr -> (lock_name, "rw"|"w")


def _parse_guarded(index: RepoIndex) -> List[GuardedClass]:
    out: List[GuardedClass] = []
    for mi in index.modules.values():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            lock_of: Dict[str, Tuple[str, str]] = {}
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                d = dotted(dec.func)
                if d is None or d.split(".")[-1] != "guarded_by":
                    continue
                if not dec.args or not isinstance(dec.args[0], ast.Constant):
                    continue
                lock_name = dec.args[0].value
                for a in dec.args[1:]:
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str):
                        lock_of[a.value] = (lock_name, "rw")
                for kw in dec.keywords:
                    if kw.arg == "writes_only" and isinstance(
                            kw.value, (ast.Tuple, ast.List)):
                        for el in kw.value.elts:
                            if isinstance(el, ast.Constant):
                                lock_of[el.value] = (lock_name, "w")
            if lock_of:
                out.append(GuardedClass(module=mi, cls_name=node.name,
                                        node=node, lock_of=lock_of))
    return out


# ---------------------------------------------------------------------------
# thread reachability
# ---------------------------------------------------------------------------

def _thread_entry_refs(index: RepoIndex) -> List[str]:
    """Functions passed as ``target=`` to ``threading.Thread``."""
    out: List[str] = []
    for mi in index.modules.values():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d is None or d.split(".")[-1] != "Thread":
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                td = dotted(kw.value)
                if td is None:
                    # lambda / nested closure target: the enclosing function
                    # is the effective entry point
                    for p in parents(node):
                        if isinstance(p, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                            for local, fi in mi.functions.items():
                                if fi.node is p:
                                    out.append(f"{mi.name}:{local}")
                            break
                    continue
                if td.startswith("self."):
                    meth = td[len("self."):]
                    for local in mi.functions:
                        if local.endswith("." + meth):
                            out.append(f"{mi.name}:{local}")
                else:
                    r = index.resolve(mi, td)
                    if r is None and "." not in td:
                        # nested entry point: Thread(target=_run) where
                        # `_run` is a def local to the enclosing method
                        for p in parents(node):
                            if isinstance(p, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)):
                                for local, fi in mi.functions.items():
                                    if fi.node is p:
                                        cand = f"{local}.{td}"
                                        if cand in mi.functions:
                                            r = f"{mi.name}:{cand}"
                                        break
                                if r:
                                    break
                    if r:
                        out.append(r)
    return out


def _racy_classes(index: RepoIndex,
                  guarded: List[GuardedClass]) -> Set[Tuple[str, str]]:
    """(module, class) pairs whose guarded state is touched from a spawned
    thread — plus classes that spawn a thread themselves (their public
    methods are the other side of the race)."""
    entries = _thread_entry_refs(index)
    reach = index.reachable(entries, unique_name_fallback=True)
    racy: Set[Tuple[str, str]] = set()
    for gc in guarded:
        prefix = f"{gc.module.name}:{gc.cls_name}."
        # a method of the class is thread-reachable
        if any(r.startswith(prefix) for r in reach):
            racy.add((gc.module.name, gc.cls_name))
            continue
        # the class itself spawns threads
        for node in ast.walk(gc.node):
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d is not None and d.split(".")[-1] == "Thread":
                    racy.add((gc.module.name, gc.cls_name))
                    break
        # or a guarded attr of it is read by thread-reachable code elsewhere
        if (gc.module.name, gc.cls_name) not in racy:
            for ref in reach:
                fi = index.func(ref)
                if fi is None:
                    continue
                for n in ast.walk(fi.node):
                    if (isinstance(n, ast.Attribute)
                            and n.attr in gc.lock_of):
                        racy.add((gc.module.name, gc.cls_name))
                        break
                else:
                    continue
                break
        # or its guarded attrs are touched from a module that spawns threads
        # (the client-facing half of a race: GNSServer.submit bumping
        # ServeMeter counters from arbitrary caller threads)
        if (gc.module.name, gc.cls_name) not in racy:
            for mi in index.modules.values():
                spawns = any(
                    isinstance(n, ast.Call)
                    and (dotted(n.func) or "").split(".")[-1] == "Thread"
                    for n in ast.walk(mi.tree))
                if not spawns:
                    continue
                if mi is gc.module or any(
                        isinstance(n, ast.Attribute)
                        and n.attr in gc.lock_of
                        for n in ast.walk(mi.tree)):
                    racy.add((gc.module.name, gc.cls_name))
                    break
    return racy


# ---------------------------------------------------------------------------
# dominance
# ---------------------------------------------------------------------------

def _under_lock(node: ast.AST, base: str, lock_name: str) -> bool:
    """Is ``node`` inside ``with <base>.<lock_name>`` (any ancestor)?"""
    want = f"{base}.{lock_name}"
    for p in parents(node):
        if isinstance(p, (ast.With, ast.AsyncWith)):
            for item in p.items:
                d = dotted(item.context_expr)
                if d == want:
                    return True
                # with self._lock: ... / cond-acquire helpers like
                # self._lock.acquire() are not with-items; only exact match
                if isinstance(item.context_expr, ast.Call):
                    dd = dotted(item.context_expr.func)
                    if dd == want:       # e.g. contextmanager wrapper
                        return True
    return False


def _method_holds(fn: ast.AST, lock_name: str) -> bool:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            d = dotted(dec.func)
            if d and d.split(".")[-1] == "holds_lock" and dec.args \
                    and isinstance(dec.args[0], ast.Constant) \
                    and dec.args[0].value == lock_name:
                return True
    return False


def _enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    for p in parents(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return p
    return None


def run(index: RepoIndex) -> List[Violation]:
    guarded = _parse_guarded(index)
    racy = _racy_classes(index, guarded)
    out: List[Violation] = []
    attr_owner: Dict[str, List[GuardedClass]] = {}
    for gc in guarded:
        for attr in gc.lock_of:
            attr_owner.setdefault(attr, []).append(gc)

    # (a) self-access inside annotated classes ------------------------------
    for gc in guarded:
        if (gc.module.name, gc.cls_name) not in racy:
            continue
        mi = gc.module
        for node in ast.walk(gc.node):
            if not isinstance(node, ast.Attribute):
                continue
            if node.attr not in gc.lock_of:
                continue
            if dotted(node) != f"self.{node.attr}":
                continue
            lock_name, mode = gc.lock_of[node.attr]
            fn = _enclosing_function(node)
            if fn is None:
                continue
            fn_name = getattr(fn, "name", "<lambda>")
            if fn_name in ("__init__", "__post_init__", "__repr__"):
                continue
            is_write = isinstance(node.ctx, (ast.Store, ast.Del)) or (
                isinstance(getattr(node, "_gns_parent", None), ast.AugAssign)
                and getattr(node, "_gns_parent").target is node)
            if mode == "w" and not is_write:
                continue
            if _under_lock(node, "self", lock_name):
                continue
            if _method_holds(fn, lock_name):
                continue
            sym = f"{gc.cls_name}.{fn_name}"
            rule = ("lock-unguarded-write" if is_write
                    else "lock-unguarded-read")
            if rule in mi.suppressed(node.lineno) \
                    or "*" in mi.suppressed(node.lineno):
                continue
            out.append(Violation(
                rule=rule, path=mi.path, line=node.lineno, symbol=sym,
                message=(f"{'write to' if is_write else 'read of'} "
                         f"`self.{node.attr}` (guarded by `{lock_name}`) "
                         f"outside `with self.{lock_name}`"),
                detail=node.attr))

    # (b) external access: obj.<guardedattr> outside `with obj.<lock>` ------
    guarded_attr_names = set(attr_owner)
    for mi in index.modules.values():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Attribute):
                continue
            if node.attr not in guarded_attr_names:
                continue
            d = dotted(node)
            if d is None or d == f"self.{node.attr}":
                continue  # self-access handled above (or unresolvable base)
            base = d[: -(len(node.attr) + 1)]
            # only flag when the base *name* matches an annotated class's
            # known instance spelling would be unsound; instead require the
            # attr be unique to annotated classes AND the base look like an
            # instance (skip module-level constants and cls refs)
            owners = attr_owner[node.attr]
            if len({(gc.module.name, gc.cls_name) for gc in owners}) != 1:
                continue
            gc = owners[0]
            if (gc.module.name, gc.cls_name) not in racy:
                continue
            lock_name, mode = gc.lock_of[node.attr]
            fn = _enclosing_function(node)
            if fn is None:
                continue  # module top level: import-time, single-threaded
            # same-class private use via another instance name is still code
            # inside the annotated class — keep; tests are excluded by scan
            # root anyway
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            if mode == "w" and not is_write:
                continue
            if _under_lock(node, base, lock_name):
                continue
            if _method_holds(fn, lock_name):
                continue
            fn_name = getattr(fn, "name", "<lambda>")
            if fn_name in ("__init__", "__repr__"):
                continue
            rule = "lock-external-access"
            if rule in mi.suppressed(node.lineno) \
                    or "*" in mi.suppressed(node.lineno):
                continue
            # locate enclosing class for the symbol, if any
            cls = None
            for p in parents(node):
                if isinstance(p, ast.ClassDef):
                    cls = p.name
                    break
            sym = f"{cls}.{fn_name}" if cls else fn_name
            out.append(Violation(
                rule=rule, path=mi.path, line=node.lineno, symbol=sym,
                message=(f"{'write to' if is_write else 'read of'} "
                         f"`{d}` (guarded by `{gc.cls_name}.{lock_name}`) "
                         f"outside `with {base}.{lock_name}`"),
                detail=f"{base}.{node.attr}"))
    return out
