"""Error-tier lint — TrafficMeter pairing, for torch's transfer idioms.

The whole paper is an argument about *bytes moved between tiers*; the port
encodes that in ``TrafficMeter``.  A host→device transfer that skips the
books silently corrupts every ``upload_ratio`` / ``bytes_per_batch``
number downstream, so: any function in the tier-transfer packages
(``featurestore/``, ``sampling/``, ``gns/``, ``serve/``, ``stream/``,
``rpc/``) that issues a host→device transfer must also book on a meter in
the same function body.  The reference's lint (``repro.analysis.meterlint``)
knows only JAX's transfers; this one knows torch's.

Counts as a host→device transfer:

* ``x.to(<device>)`` / ``x.to(device=<device>)`` (tensors, modules, the
  port's ``DeviceBatch``);
* ``x.cuda()``;
* ``torch.tensor`` / ``torch.as_tensor`` / ``torch.asarray`` with a
  ``device=`` (``torch.from_numpy`` takes none: its chained ``.to(dev)`` is
  the transfer);
* ``dst.copy_(src, ...)`` where ``dst`` is visibly on the device (bound in
  the function to a device-placed tensor, or named ``*dev*``/``*gpu*``/
  ``*cuda*``) and ``src`` is not.

Never counted: dtype casts (``x.to(torch.int32)``, ``x.to(y.dtype)``),
``.to("cpu")`` / ``.to(torch.device("cpu"))`` (device→host), on-device
allocations (``torch.empty(..., device=dev)``), and calls that merely
forward ``device=`` to another constructor.

How an argument is read: a ``torch.<dtype>`` name, or a name or attribute
spelled ``*dtype``, is a dtype; ``torch.device(...)``, a ``"cuda…"``
string, or a name or attribute spelled ``device``/``dev``/``*_device``/
``*_dev`` is a device.  An argument the AST cannot classify (``x.to(t)``)
counts as a device: the pass errs toward a finding, and a spelled-out
device or dtype settles it.

What counts as booking: a mention of a meter marker in the body
(``meter``, ``self.meter``, ``account``, ``record_upload``, any
``.bytes_*`` / ``.t_*`` attribute).  Unlike the reference, a parameter
named ``meter`` that the body never uses does not: a function must book
the copy, not merely be handed the meter.  A nested ``def``'s transfers
are its own, not its parent's.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional

from .common import ModuleInfo, RepoIndex, Violation, dotted

SCOPE_PREFIXES = ("repro_torch/featurestore/", "repro_torch/sampling/",
                  "repro_torch/gns/", "repro_torch/serve/",
                  "repro_torch/stream/", "repro_torch/rpc/",
                  "featurestore/", "sampling/", "gns/", "serve/", "stream/",
                  "rpc/")
# device-side math and kernel wrappers: their casts and allocations are not
# tier transfers
EXCLUDE_SUFFIXES = ("kernels.py", "ref.py", "rng.py", "ops.py")
METER_MARKERS = {"meter", "bytes_cache_upload", "bytes_adj_upload",
                 "bytes_gather", "account", "record_upload"}

HOST_TO_DEVICE_CTORS = {"torch.tensor", "torch.as_tensor", "torch.asarray"}
DTYPES = {"bool", "uint8", "int8", "int16", "short", "int32", "int",
          "int64", "long", "uint16", "uint32", "uint64", "float16", "half",
          "bfloat16", "float32", "float", "float64", "double", "complex32",
          "complex64", "cfloat", "complex128", "cdouble",
          "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
          "float8_e5m2fnuz", "qint8", "quint8", "qint32"}
DEVICE_HINTS = ("dev", "gpu", "cuda")   # spelled into a device tensor's name


@dataclasses.dataclass(frozen=True)
class Transfer:
    path: str
    line: int
    symbol: str              # local qualname of the enclosing def
    call: str                # dotted callee as written
    paired: bool             # the function books on a meter


def _full_name(mi: ModuleInfo, d: str) -> str:
    """``d`` with its head resolved through the module's imports."""
    head, _, rest = d.partition(".")
    imp = mi.imports.get(head)
    if imp is None:
        return d
    return f"{imp}.{rest}" if rest else imp


def _kind(mi: ModuleInfo, expr: ast.AST) -> str:
    """"device" | "cpu" | "dtype" | "none" | "unknown" for one argument."""
    if isinstance(expr, ast.Constant):
        if expr.value is None:
            return "none"
        if isinstance(expr.value, str):
            return "cpu" if expr.value.startswith("cpu") else "device"
        return "unknown"
    if isinstance(expr, ast.Call):
        d = dotted(expr.func)
        if d is not None and _full_name(mi, d) == "torch.device":
            if expr.args and isinstance(expr.args[0], ast.Constant) \
                    and str(expr.args[0].value).startswith("cpu"):
                return "cpu"
            return "device"
        return "unknown"
    d = dotted(expr)
    if d is None:
        return "unknown"
    full = _full_name(mi, d)
    tail = full.rsplit(".", 1)[-1].lower()
    if full.startswith("torch.") and full.count(".") == 1 and tail in DTYPES:
        return "dtype"
    if tail.endswith("dtype"):
        return "dtype"
    if tail in ("device", "dev") or tail.endswith(("_device", "_dev")):
        return "device"
    return "unknown"


def _moves_to_device(kinds: List[str]) -> bool:
    return any(k in ("device", "unknown") for k in kinds)


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_upload(mi: ModuleInfo, call: ast.Call) -> bool:
    """A ``.to``/``.cuda``/constructor transfer (``copy_`` needs the
    function's bindings: see :func:`_copy_is_upload`)."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == "to":
        kinds = [_kind(mi, a) for a in call.args]
        dev = _kw(call, "device")
        if dev is not None:
            kinds.append(_kind(mi, dev))
        return _moves_to_device(kinds)
    if isinstance(func, ast.Attribute) and func.attr == "cuda":
        d = dotted(func.value)
        return d is None or _full_name(mi, d) != "torch"
    d = dotted(func)
    if d is not None and _full_name(mi, d) in HOST_TO_DEVICE_CTORS:
        dev = _kw(call, "device")
        if dev is None and _full_name(mi, d) == "torch.as_tensor" \
                and len(call.args) >= 3:
            dev = call.args[2]
        return dev is not None and _moves_to_device([_kind(mi, dev)])
    return False


def _device_placed(mi: ModuleInfo, expr: ast.AST,
                   bound: Dict[str, ast.AST], depth: int = 0) -> bool:
    """Is ``expr`` visibly a tensor on the device?"""
    if depth > 4:
        return False
    if isinstance(expr, ast.Call):
        if _is_upload(mi, expr):
            return True
        d = dotted(expr.func)
        if d is not None and _full_name(mi, d).startswith("torch."):
            dev = _kw(expr, "device")
            return dev is not None and _kind(mi, dev) == "device"
        return False
    d = dotted(expr)
    if d is None:
        return False
    if d in bound:
        return _device_placed(mi, bound[d], bound, depth + 1)
    tail = d.rsplit(".", 1)[-1].lower()
    return any(h in tail for h in DEVICE_HINTS) \
        and _kind(mi, expr) != "device"      # `self.device` is no tensor


def _copy_is_upload(mi: ModuleInfo, call: ast.Call,
                    bound: Dict[str, ast.AST]) -> bool:
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr == "copy_"
            and call.args):
        return False
    return (_device_placed(mi, func.value, bound)
            and not _device_placed(mi, call.args[0], bound))


def _own_nodes(fn: ast.AST):
    """The nodes of ``fn``'s body, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _fn_has_meter(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and (
                node.attr in METER_MARKERS
                or node.attr.startswith("bytes_")
                or node.attr.startswith("t_")):
            return True
        if isinstance(node, ast.Name) and node.id in METER_MARKERS:
            return True
    return False


def _in_scope(mi: ModuleInfo) -> bool:
    # scoped to the tier-transfer packages inside the port; an arbitrary
    # scan root (the analyzer's own test fixtures) is all in scope — there
    # is no package structure to scope by
    in_port = mi.name.split(".")[0] == "repro_torch"
    if in_port and not mi.path.startswith(SCOPE_PREFIXES):
        return False
    return not mi.path.endswith(EXCLUDE_SUFFIXES)


def _function_transfers(mi: ModuleInfo, fn: ast.AST) -> List[ast.Call]:
    bound: Dict[str, ast.AST] = {}
    nodes = sorted(_own_nodes(fn), key=lambda n: (
        getattr(n, "lineno", 0), getattr(n, "col_offset", 0)))
    for node in nodes:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            d = dotted(node.targets[0])
            if d is not None:
                bound[d] = node.value
    out: List[ast.Call] = []
    for node in nodes:
        if isinstance(node, ast.Call) and (
                _is_upload(mi, node) or _copy_is_upload(mi, node, bound)):
            out.append(node)
    return out


def find_transfers(index: RepoIndex) -> List[Transfer]:
    """Every host→device transfer site in scope, with whether its function
    books on a meter."""
    out: List[Transfer] = []
    for mi in index.modules.values():
        if not _in_scope(mi):
            continue
        for local, fi in mi.functions.items():
            calls = _function_transfers(mi, fi.node)
            if not calls:
                continue
            paired = _fn_has_meter(fi.node)
            for c in calls:
                out.append(Transfer(
                    path=mi.path, line=c.lineno, symbol=local,
                    call=dotted(c.func) or f"<expr>.{c.func.attr}",
                    paired=paired))
    return out


def run(index: RepoIndex) -> List[Violation]:
    out: List[Violation] = []
    by_fn: Dict[tuple, List[Transfer]] = {}
    for t in find_transfers(index):
        by_fn.setdefault((t.path, t.symbol), []).append(t)
    for (path, local), ts in by_fn.items():
        if ts[0].paired:
            continue
        mi = index.by_path[path]
        first = ts[0]
        sup = mi.suppressed(first.line)
        if "meter-unpaired-transfer" in sup or "*" in sup:
            continue
        out.append(Violation(
            rule="meter-unpaired-transfer", path=path, line=first.line,
            symbol=local,
            message=(f"{len(ts)} device transfer(s) (`{first.call}`) with "
                     "no TrafficMeter accounting in the same function — "
                     "unbooked tier traffic"),
            detail=local, severity="error"))
    return out
