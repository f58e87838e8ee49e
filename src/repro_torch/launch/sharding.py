"""Logical-axis sharding rules (DP / TP / EP / SP) with divisibility
fallback, and the shard plans that apply them on a mesh of ranks (port of
``repro.launch.sharding``).

Model code and the launchers speak of *logical* axes; this module maps
them to the mesh's physical axes:

    batch  -> ('pod', 'data')     data parallel (pods are extra DP)
    model  -> 'model'             tensor parallel
    expert -> 'model'             MoE expert parallel (same axis as TP)
    seq    -> 'data'              sequence parallel (long-context decode)
    None   -> replicated

Divisibility fallback: a logical axis whose dimension does not divide by
the physical axis size falls back to the longest prefix of its axes that
divides, else to replication (xlstm-125m's 4 heads on a model=16 axis
replicate; its 1536-wide inner dim still shards), and each mesh axis
shards at most one dim of a tensor.  This is what lets one rule table
serve architectures from 125M to 480B.

The reference turns a spec into a ``NamedSharding`` and lets GSPMD place
the arrays.  Here a spec is a tuple with one entry per dim (None, an axis
name, or a tuple of axis names: ``tuple(PartitionSpec)`` of the
reference's), and a :class:`ShardPlan` applies it on a
:class:`~repro_torch.launch.mesh.HostMesh`: ``local(full)`` slices this
rank's block of a full tensor and ``gather(local)`` rebuilds the full
tensor from every rank's block.  The rules read only a mesh's
``axis_names`` and ``shape``, so a plan of a mesh with no ranks behind it
(the production 16x16 mesh) still names its spec and local shape.

:func:`use_mesh` puts a mesh in scope for the calling thread and
:func:`current_mesh` reads it: the GNS model routes its layer 0 through
the sharded kernels, and the LM zoo's layers run their tensor- and
expert-parallel forms (``launch/collectives.py``), when a mesh is in
scope; with none they run the single-device path.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_LOGICAL_TO_PHYSICAL = {
    "batch": ("pod", "data"),
    "model": ("model",),
    "expert": ("model",),
    "seq": ("data",),
    "attn_sq": ("model",),     # seq-sharded attention (heads % tp != 0)
    "cache": ("model",),       # feature-store device-table rows
    "pod": ("pod",),
    "data": ("data",),
}

_state = threading.local()


def current_mesh():
    """The mesh :func:`use_mesh` put in scope on this thread, or None."""
    return getattr(_state, "mesh", None)


def logical_table() -> dict:
    return {**_LOGICAL_TO_PHYSICAL, **getattr(_state, "overrides", {})}


@contextlib.contextmanager
def logical_overrides(**kw):
    """Remap logical axes for a scope (e.g. pure DP: batch spans all
    axes)."""
    prev = getattr(_state, "overrides", {})
    _state.overrides = {**prev, **kw}
    try:
        yield
    finally:
        _state.overrides = prev


@contextlib.contextmanager
def arch_scope(cfg):
    """Per-arch distribution scope.  ``pure_dp``: the whole mesh is data
    parallelism (batch -> pod x data x model), TP/EP disabled, parameters
    ZeRO-3-sharded over everything."""
    if getattr(cfg, "pure_dp", False):
        if cfg.moe is not None:
            raise ValueError("pure_dp is invalid for MoE archs (EP needs "
                             "'model')")
        with logical_overrides(batch=("pod", "data", "model"),
                               model=(), expert=(), attn_sq=(), seq=()):
            yield
    else:
        yield


@contextlib.contextmanager
def serve_layout(replicated_batch: bool = False, self_split: bool = False,
                 cross_split: bool = False):
    """How a decode state lies on the data axis, for a serving step's
    scope (``launch/steps.py::mesh_layout`` reads it off the plans):
    ``replicated_batch`` — the batch does not divide the data axis, so
    every data rank holds the same rows (the MoE layer then routes them
    as they are, not gathered over the axis); ``self_split`` /
    ``cross_split`` — the self-attention caches (KV, ring, MLA latent) /
    the enc-dec cross K/V are split along their slots over ``data``."""
    prev = getattr(_state, "layout", None)
    _state.layout = {"replicated_batch": replicated_batch,
                     "self": self_split, "cross": cross_split}
    try:
        yield
    finally:
        _state.layout = prev


def layout(key: str) -> bool:
    """A field of the :func:`serve_layout` in scope (False without one)."""
    lay = getattr(_state, "layout", None)
    return bool(lay and lay[key])


def batch_axes(mesh) -> tuple:
    """Mesh axes carrying the logical batch (override-aware)."""
    return tuple(a for a in logical_table()["batch"] if a in mesh.axis_names)


@contextlib.contextmanager
def use_mesh(mesh):
    """Thread-local mesh scope (``None`` scopes no mesh)."""
    prev: Optional[object] = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _physical_axes(mesh, logical: Optional[str], dim: int):
    """One logical axis -> the tuple of mesh axes that divide ``dim``."""
    if logical is None:
        return None
    axes = [a for a in logical_table().get(logical, ())
            if a in mesh.axis_names]
    keep, prod = [], 1
    for a in axes:                   # the longest prefix that divides
        if dim % (prod * mesh.shape[a]):
            break
        keep.append(a)
        prod *= mesh.shape[a]
    return tuple(keep) or None


def spec_for(mesh, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> tuple:
    """Logical axes -> the spec: per dim None, one axis name, or a tuple of
    axis names (module docstring)."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"{len(logical_axes)} logical axes for shape "
                         f"{tuple(shape)}")
    used: set = set()
    parts = []
    for name, dim in zip(logical_axes, shape):
        ax = _physical_axes(mesh, name, dim)
        if ax is not None and any(a in used for a in ax):
            ax = None                       # each mesh axis used at most once
        if ax is not None:
            used.update(ax)
            parts.append(ax if len(ax) > 1 else ax[0])
        else:
            parts.append(None)
    return tuple(parts)


def axis_size(name: str) -> int:
    """Size of a mesh axis in the current scope (1 if absent / no mesh)."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def model_sharded(dim: int) -> bool:
    """Whether a dim whose logical axis is ``model`` shards on the mesh in
    scope (the rule table's answer for a lone ``model`` dim)."""
    mesh = current_mesh()
    return (mesh is not None and axis_size("model") > 1
            and spec_for(mesh, ("model",), (dim,))[0] is not None)


# ---------------------------------------------------------------------------
# Parameter rule table (name-suffix based)
# ---------------------------------------------------------------------------
# Megatron-style TP: column-parallel ("in -> sharded hidden") wq/wk/wv/w1/w3
# ...; row-parallel ("sharded hidden -> out") wo/w2/out_proj ...; expert-
# parallel experts_* on their leading E dim; embeddings on the vocab dim.
# Stacked-layer params carry a leading L dim, so the rules are right-
# aligned.  ``fsdp=True`` also shards the largest replicated dim over the
# DP axes (ZeRO-3).

_PARAM_RULES: list[tuple[tuple[str, ...], tuple]] = [
    (("embed",),            ("model", None)),     # tied: unembed-side local
    (("embed_in",),         (None, "model")),     # untied input: local gather
    (("unembed",),          (None, "model")),
    (("experts_w1", "experts_w3"), ("expert", None, "model")),
    (("experts_w2",),       ("expert", "model", None)),
    (("wq", "wk", "wv", "w_qkv", "w1", "w3", "in_proj", "q_up", "k_up", "v_up",
      "w_gate_up", "conv_w", "w_ih"), (None, "model")),
    (("wo", "w2", "out_proj", "w_down"), ("model", None)),
    (("bq", "bk", "bv", "b1", "b3", "b_in"), ("model",)),
    (("q_down", "kv_down", "router", "w_hh"), (None, None)),
    (("a_log", "ssm_d", "dt_bias", "heads_scale"), ("model",)),
]


def infer_logical_axes(path: str, shape) -> tuple:
    """Logical axes for a param leaf, right-aligned to its shape."""
    leaf = path.split("/")[-1]
    rule = None
    for names, axes in _PARAM_RULES:
        if leaf in names:
            rule = axes
            break
    if rule is None:
        rule = (None,) * len(shape)
    if len(rule) < len(shape):                 # stacked-layer leading dims
        rule = (None,) * (len(shape) - len(rule)) + tuple(rule)
    elif len(rule) > len(shape):
        rule = tuple(rule[-len(shape):])
    return tuple(rule)


# ---------------------------------------------------------------------------
# shard plans
# ---------------------------------------------------------------------------

def _part_axes(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


class ShardPlan:
    """One leaf's spec applied on a mesh (module docstring).

    ``spec`` is the per-dim spec, ``shape`` the full shape; ``dims`` gives
    each dim's axes as a tuple (``()``: whole), ``axes`` every axis the
    leaf shards over.  ``local`` and ``gather`` need a
    :class:`~repro_torch.launch.mesh.HostMesh` (its ``index`` and
    ``group``); a leaf that is not a tensor (the optimizer's step count)
    passes through both."""

    def __init__(self, mesh, spec: tuple, shape: Sequence[int]) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(int(s) for s in shape)
        self.dims = tuple(_part_axes(p) for p in self.spec)
        self.axes = frozenset(a for d in self.dims for a in d)

    def __repr__(self) -> str:
        return f"ShardPlan(spec={self.spec}, shape={self.shape})"

    def _ways(self, axes: tuple) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def local_shape(self) -> tuple:
        return tuple(s // self._ways(d) for s, d in zip(self.shape, self.dims))

    def _block(self, axes: tuple) -> int:
        """This rank's block index along a dim sharded over ``axes`` (the
        first axis major, as a jax mesh orders them)."""
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + self.mesh.index(a)
        return i

    def local(self, full):
        """This rank's block of ``full`` (a contiguous tensor of its own,
        so the full tensor can be freed)."""
        if not isinstance(full, torch.Tensor) or not self.axes:
            return full
        if tuple(full.shape) != self.shape:
            raise ValueError(f"{self}: got shape {tuple(full.shape)}")
        out = full
        for dim, (n, axes) in enumerate(zip(self.local_shape, self.dims)):
            if axes:
                out = out.narrow(dim, self._block(axes) * n, n)
        return out.clone(memory_format=torch.contiguous_format)

    def gather(self, local):
        """The full tensor from every rank's block (collectives over the
        groups of the leaf's axes: every rank of those groups must call
        it, in one order; no autograd)."""
        if not isinstance(local, torch.Tensor) or not self.axes:
            return local
        out = local.contiguous()
        for dim, axes in enumerate(self.dims):
            for a in reversed(axes):            # the minor axis first
                parts = [torch.empty_like(out)
                         for _ in range(self.mesh.shape[a])]
                dist.all_gather(parts, out, group=self.mesh.group(a))
                out = torch.cat(parts, dim=dim)
        return out


def param_sharding(mesh, logical_axes, shape,
                   fsdp: bool = False) -> ShardPlan:
    """The plan of a parameter leaf: :func:`spec_for`, and with ``fsdp``
    the largest still-replicated dim that divides the DP extent sharded
    over the DP axes (ZeRO-3), unless a DP axis is used already."""
    spec = spec_for(mesh, logical_axes, shape)
    dp_axes = batch_axes(mesh)
    if not fsdp or not dp_axes:
        return ShardPlan(mesh, spec, shape)
    used = {a for part in spec for a in _part_axes(part)}
    if any(a in used for a in dp_axes):
        return ShardPlan(mesh, spec, shape)
    dp_total = 1
    for a in dp_axes:
        dp_total *= mesh.shape[a]
    best, best_dim = None, 0
    for i, (part, dim) in enumerate(zip(spec, shape)):
        if part is None and dim % dp_total == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is not None:
        parts = list(spec)
        parts[best] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        spec = tuple(parts)
    return ShardPlan(mesh, spec, shape)


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts / lists / tuples, paths joined
    by ``/`` as ``jax.tree_util`` names them (the rule table's keys)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path
                                        else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_param_shardings(mesh, params, fsdp: bool = False):
    """A :class:`ShardPlan` per leaf of a parameter tree (nested dicts /
    lists of tensors, or of anything with a ``shape``), by the rule
    table."""
    def one(path, x):
        shape = tuple(x.shape)
        return param_sharding(mesh, infer_logical_axes(path, shape), shape,
                              fsdp=fsdp)
    return map_with_path(one, params)
