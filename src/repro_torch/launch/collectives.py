"""Collectives with gradients, over a process group of the mesh in scope
(what the reference gets from ``shard_map`` and GSPMD).

Every rank of a model group runs the same program on its own shard of the
weights; the activations between the parallel regions are replicated, so
every rank computes the same loss and, through the pairs below, the full
gradient of every replicated tensor (Megatron's f / g):

* :func:`copy_to` — identity forward, ``all_reduce`` backward: the entry
  of a region whose ranks each use the tensor only in part (a column-
  parallel product, head-local attention, the local experts' routing);
* :func:`reduce_from` — ``all_reduce`` forward, identity backward: the
  exit of such a region (a row-parallel product, the expert combine);
* :func:`gather` — list ``all_gather`` along a dim forward; backward
  either sums the gradient over the group and then slices this rank's
  block (``partial=True``: the ranks each use the gathered tensor in part,
  as head-local attention uses gathered K/V, or as the data ranks each
  use a ZeRO-3 weight on their own rows) or only slices it (the gathered
  tensor is used whole and alike on every rank);
* :func:`group_sum` — ``all_reduce`` forward and backward: a sum over
  the group whose result every rank uses only in part (the mean of
  squares of a norm over a feature dim the ranks split);
* :func:`whole` — a leaf whole from this rank's block of it (the dim
  where the shapes differ gathered; a leaf the rule table left whole
  passes through, through :func:`copy_to` when ``partial``): the layers
  that use a leaf in a way its split does not follow (Mamba2's ``conv_w``
  across the ``x | B | C`` boundary, a head count that does not divide
  the axis); :func:`head_split` picks between a layer's head-local form
  and that whole form;
* :func:`vocab_embed` and :func:`vocab_nll` — a lookup in a table whose
  rows (the vocab) are split over the group, and the token NLL of logits
  whose last dim is: the max, the sum of exponentials and the label's
  logit are reduced over the group, never the ``[B, S, V]`` logits.

Only ``all_reduce``, list ``all_gather`` and ``broadcast`` are used, the
collectives gloo carries for CPU and CUDA tensors alike.  A group of one
rank makes every function here the identity, and a ``meta`` tensor (the
dry-run's) is recorded and moves nothing: it has no data to move.

**The recorder.**  Under :func:`recording` (off unless a dry-run or a
calibration turns it on), every collective this module issues on the
calling thread — and ``kernels/ops.py::psum`` — is appended to a log as
``{"op", "bytes", "group", "spans_nodes", "site"}``: the op in the
reference's HLO naming, its result bytes (an all-gather's: the gathered
size), the group's size, whether its ranks span nodes of 8 and the model
call site (``file:line`` of the first frame outside this module; a
backward's carries its forward's site).  The log replaces parsing
post-SPMD HLO text (``roofline/analysis.py::collective_bytes``).  A
backward that runs on another thread (CUDA's autograd thread) logs into
the log its forward was recorded in.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.launch.sharding import current_mesh, layout, model_sharded
from repro_torch.roofline.analysis import spans_nodes

_rec = threading.local()
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames the call site skips: this module, the kernels' psum, the counter
_SKIP = (os.path.abspath(__file__),
         os.path.join(_PKG, "kernels", "ops.py"),
         os.path.join(_PKG, "roofline", "analysis.py"),
         os.path.join(_PKG, "models", "scan_util.py"))


@contextlib.contextmanager
def recording(log: Optional[list] = None):
    """Log every collective this thread issues (module docstring) into
    ``log`` (a new list when None), yielded; nests, restoring the outer
    log on exit."""
    prev = getattr(_rec, "log", None)
    _rec.log = [] if log is None else log
    try:
        yield _rec.log
    finally:
        _rec.log = prev


def current_log() -> Optional[list]:
    """The log :func:`recording` opened on this thread, or None."""
    return getattr(_rec, "log", None)


def call_site() -> str:
    """``path:line`` (relative to the package) of the innermost frame of
    the port outside this module, the psum and the counter; ``?`` when
    there is none."""
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG) and fn not in _SKIP:
            return f"{os.path.relpath(fn, _PKG)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def record(op: str, nbytes: int, group, site: Optional[str] = None,
           log: Optional[list] = None) -> None:
    """Append one collective of ``nbytes`` result bytes to ``log``
    (default: this thread's); no-op when nothing records."""
    log = current_log() if log is None else log
    if log is None:
        return
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    log.append({"op": op, "bytes": int(nbytes),
                "group": len(ranks), "spans_nodes": spans_nodes(ranks),
                "site": site or call_site()})


def model_group():
    """(group, size, index) of the model axis of the mesh in scope; size 1
    (and no group) without one."""
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None, 1, 0
    return mesh.group("model"), mesh.shape["model"], mesh.index("model")


def data_group():
    """(group, size, index) of the data-parallel axes of the mesh in
    scope: ``data``, or ``pod`` × ``data`` on a pod mesh."""
    mesh = current_mesh()
    if mesh is None:
        return None, 1, 0
    if "pod" in mesh.axis_names:
        size = mesh.shape["pod"] * mesh.shape["data"]
        return (mesh.group("batch"), size,
                mesh.index("pod") * mesh.shape["data"] + mesh.index("data"))
    if mesh.shape.get("data", 1) == 1:
        return None, 1, 0
    return mesh.group("data"), mesh.shape["data"], mesh.index("data")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def seq_group(kind: str = "self"):
    """(group, size, index) of the data axis when the serving layout in
    scope splits ``kind``'s cache slots over it (``sharding.serve_layout``
    — rank ``i`` holds the i-th contiguous slice), else ``(None, 1, 0)``."""
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("data", 1) == 1 or not layout(kind):
        return None, 1, 0
    return mesh.group("data"), mesh.shape["data"], mesh.index("data")


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
               site: Optional[str] = None,
               log: Optional[list] = None) -> torch.Tensor:
    """The reduction over ``group`` of a copy of ``x`` (``x`` unchanged);
    ``group`` None (an axis of one rank) reduces nothing.  ``site`` and
    ``log``: the recorder's (module docstring)."""
    if group is None:
        return x
    out = x.contiguous().clone()
    record("all-reduce", _nbytes(out), group, site, log)
    if not out.is_meta:
        dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    record("all-gather", _nbytes(x) * n, group)
    if not x.is_meta:
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``dist.broadcast`` of ``t`` in place from global rank ``src``
    over ``group``, recorded; returns ``t``."""
    record("broadcast", _nbytes(t), group)
    if not t.is_meta:
        dist.broadcast(t, src=src, group=group)
    return t


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.log = current_log()
        ctx.site = call_site() if ctx.log is not None else None
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        site = ctx.site and ctx.site + " (backward)"
        return all_reduce(g, ctx.group, site=site, log=ctx.log), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        ctx.n = x.shape[dim]
        ctx.rank = dist.get_rank(group)
        ctx.log = current_log()
        ctx.site = call_site() if ctx.log is not None else None
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            site = ctx.site and ctx.site + " (backward)"
            g = all_reduce(g, ctx.group, site=site, log=ctx.log)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward; identity backward."""
    return x if group is None else _Reduce.apply(x, group)


def gather(x: torch.Tensor, group, dim: int, partial: bool) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``, in rank order (module docstring
    for ``partial``)."""
    return x if group is None else _Gather.apply(x, group, dim, partial)


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward, and the gradient summed over
    it backward: each rank uses the sum only in part (module
    docstring)."""
    return copy_to(reduce_from(x, group), group)


def whole(x: torch.Tensor, shape, group, partial: bool) -> torch.Tensor:
    """The full ``shape`` of a leaf from this rank's block ``x`` of it,
    split over ``group`` along at most one dim (module docstring):
    ``partial`` as in :func:`gather` (whether the ranks each use the
    whole leaf only in part)."""
    if group is None:
        return x
    dims = [i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b]
    if not dims:
        return copy_to(x, group) if partial else x
    if len(dims) > 1 or x.dim() != len(shape):
        raise ValueError(f"a block {tuple(x.shape)} of {tuple(shape)}")
    return gather(x, group, dim=dims[0], partial=partial)


def head_split(p: dict, heads: int, shapes: dict) -> tuple:
    """``(p, group, ranks, index)`` of a layer that runs its heads on the
    model axis in scope: ``p`` as given when ``heads`` divide the axis
    (the rule table then split its leaves along whole heads), else every
    leaf gathered whole (``shapes``: the full ones) and the layer run
    alike on every rank (group None, one rank); ``(p, None, 1, 0)``
    without a model axis."""
    group, tp, m = model_group()
    if group is None:
        return p, None, 1, 0
    if heads % tp == 0 and model_sharded(heads):
        return p, group, tp, m
    return ({k: whole(v, shapes[k], group, partial=False)
             for k, v in p.items()}, None, 1, 0)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, group,
                index: int) -> torch.Tensor:
    """``full_table[tokens]`` from this rank's rows ``table`` (rows
    ``[index·n, (index+1)·n)`` of the full table): a masked local lookup
    summed over the group."""
    n = table.shape[0]
    local = tokens.long() - index * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce_from(torch.where(hit[..., None], rows, 0), group)


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group, index):
        x = logits.float()
        n = x.shape[-1]
        m = all_reduce(x.amax(dim=-1), group, dist.ReduceOp.MAX)
        e = torch.exp(x - m[..., None])
        s = all_reduce(e.sum(dim=-1), group)
        local = labels.long() - index * n
        hit = (local >= 0) & (local < n)
        gold = torch.gather(x, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = all_reduce(torch.where(hit, gold, 0.0), group)
        ctx.save_for_backward(e, s, local, hit)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - gold

    @staticmethod
    def backward(ctx, g):
        e, s, local, hit = ctx.saved_tensors
        grad = e / s[..., None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, local.clamp(0, grad.shape[-1] - 1)[..., None],
            hit[..., None].to(grad.dtype))
        return ((grad - onehot) * g[..., None]).to(ctx.dtype), None, None, \
            None


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, group,
              index: int) -> torch.Tensor:
    """Per-token NLL in f32 of logits whose last dim is this rank's slice
    ``[index·n, (index+1)·n)`` of the vocab (the same on every rank of
    the group)."""
    return _VocabNLL.apply(logits, labels, group, index)
