"""Three-term roofline of one counted step (port of
``repro.roofline.analysis``).

Terms (per step, per device — a dry-run counts one rank's program, so
every number is already per device):

  compute_s    = FLOPs_per_device / peak_FLOPs
  memory_s     = bytes_per_device / HBM_bw
  collective_s = wire bytes per device / link rate

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and the
collectives from the post-SPMD HLO text.  Here one eager run of the real
step is counted instead (:class:`StepCounter`, a ``TorchDispatchMode``):

* FLOPs through ``torch.utils.flop_counter``'s formulas (matmul-class ops
  only: elementwise work counts 0);
* bytes as each non-view aten op's tensor inputs read once plus its
  outputs written once (eager execution materialises every intermediate
  that XLA would fuse away, so this term is an upper bound of the fused
  program's);
* peak live bytes by tensor lifetime: the bytes the step's ops allocate,
  at their most at once (the counterpart of ``memory_analysis``'s temp
  bytes).

Collectives are logged as they are issued (``launch/collectives.py``'s
recorder): ``(op, result bytes, group size, spans_nodes, site)``, and
:func:`collective_bytes` applies the reference's ring formulas to that log.

**The card and its links.**  :data:`H100_SXM` is the default: 989 TFLOP/s
bf16 dense, 3.35 TB/s HBM, 80 GB.  Its collective term has two rates: a
group whose ranks all lie on one node of 8 ranks (consecutive global ranks
share a node: ranks 0-7, 8-15, ...) runs over NVLink at 450 GB/s a
direction; a group that spans nodes runs at the inter-node network's
50 GB/s a GPU.  A record's bytes are summed per tier and the term is
``nvlink_bytes / 450e9 + network_bytes / 50e9``.  :data:`V5E` is the
reference's TPU entry, kept only as the input its parity tests pass; with
no NVLink tier the term is the reference's ``total / ici_bw``.

The dominant term approximates step time under perfect overlap; the
roofline fraction is ``useful_model_flops / (dominant_s * peak * chips)``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-device numbers.  ``nvlink_bw`` None: one link tier at
    ``ici_bw``; else groups within a node of ``node_size`` consecutive
    ranks run at ``nvlink_bw`` and the others at ``ici_bw``."""
    peak_flops: float = 197e12        # bf16 FLOP/s
    hbm_bw: float = 819e9             # B/s
    ici_bw: float = 50e9              # B/s per link (H100: network a GPU)
    hbm_bytes: float = 16e9           # capacity (memory table)
    nvlink_bw: Optional[float] = None
    node_size: int = 0
    name: str = "v5e"


V5E = HW()
H100_SXM = HW(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=50e9,
              hbm_bytes=80e9, nvlink_bw=450e9, node_size=8,
              name="h100-sxm")
DEFAULT_HW = H100_SXM

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "broadcast")

# ring-algorithm wire bytes per device, from the result bytes and group size
# (the reference's table; a broadcast sends its result once, as a permute)
_RING = {
    "all-gather": lambda rb, s: rb * (s - 1) // max(s, 1),
    "all-reduce": lambda rb, s: 2 * rb * (s - 1) // max(s, 1),
    "reduce-scatter": lambda rb, s: rb * (s - 1),
    "all-to-all": lambda rb, s: rb * (s - 1) // max(s, 1),
    "collective-permute": lambda rb, s: rb,
    "broadcast": lambda rb, s: rb,
}


def spans_nodes(ranks, node_size: int = 8) -> bool:
    """Whether a group of global ``ranks`` spans more than one node of
    ``node_size`` consecutive ranks."""
    return len({r // node_size for r in ranks}) > 1


def collective_bytes(log) -> dict:
    """Per-device wire bytes per collective type, from a recorder log.

    ``log``: records with ``op``, ``bytes`` (the result's: the gathered
    size of an all-gather), ``group`` (size) and ``spans_nodes``.  The
    reference's ring formulas (:data:`_RING`); returns ``{op: {"bytes",
    "count"}, ..., "total", "nvlink_bytes", "network_bytes"}``."""
    out: dict = {c: {"bytes": 0, "count": 0} for c in _COLLECTIVES}
    total = nvlink = network = 0
    for r in log:
        op = r["op"]
        s = max(int(r["group"]), 1)
        b = int(_RING[op](int(r["bytes"]), s))
        out[op]["bytes"] += b
        out[op]["count"] += 1
        total += b
        if r.get("spans_nodes"):
            network += b
        else:
            nvlink += b
    out["total"] = total
    out["nvlink_bytes"] = nvlink
    out["network_bytes"] = network
    return out


def model_flops(cfg: ArchConfig, shape: ShapeSpec,
                n_active: Optional[float] = None) -> float:
    """Useful MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per step.

    D = tokens processed this step (decode: global_batch new tokens).
    N counts active parameters (MoE: shared + top_k routed experts + attn).
    ``n_active`` overrides the analytic count with the exact number derived
    from param structs (launch/dryrun.py does this).
    """
    n = n_active if n_active is not None else active_params(cfg)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d                    # forward only
    return 2.0 * n * shape.global_batch      # decode: 1 token per sequence


def total_params(cfg: ArchConfig) -> float:
    return _param_count(cfg, active_only=False)


def active_params(cfg: ArchConfig) -> float:
    return _param_count(cfg, active_only=True)


def _param_count(cfg: ArchConfig, active_only: bool) -> float:
    d, l = cfg.d_model, cfg.num_layers
    dh = cfg.head_dim_eff
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    # attention
    if cfg.mla is not None:
        m = cfg.mla
        attn = (d * m.q_lora + m.q_lora * h * (m.qk_nope + m.qk_rope)
                + d * (m.kv_lora + m.qk_rope)
                + m.kv_lora * h * (m.qk_nope + m.v_head)
                + h * m.v_head * d)
    else:
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
    # ffn / moe / xlstm / ssm per layer
    def ffn_params(dff):
        return d * dff * (3 if cfg.gated_ffn else 2)

    per_layer = attn
    if cfg.moe is not None:
        mo = cfg.moe
        e_active = mo.top_k if active_only else mo.num_experts
        per_layer += 3 * d * mo.d_expert * e_active
        per_layer += d * mo.num_experts            # router
        if mo.num_shared:
            per_layer += 3 * d * (mo.d_expert * mo.num_shared)
        if mo.dense_residual:
            per_layer += ffn_params(cfg.d_ff)
        dense_layers = mo.first_dense_layers
        moe_layers = l - dense_layers
        total = moe_layers * per_layer + dense_layers * (attn + ffn_params(cfg.d_ff))
    elif cfg.xlstm is not None:
        x = cfg.xlstm
        di = int(x.proj_factor * d)
        dqk = int(x.qk_factor * di)
        mlstm = (2 * d * di + di * dqk * 2 + di * di + di * 2 * x.num_heads
                 + di * di + di * d)
        n_s = len(x.slstm_at)
        total = (l - n_s) * mlstm + n_s * (4 * d * d + d * d)
    elif cfg.ssm is not None:
        s = cfg.ssm
        di = s.expand * d
        conv_dim = di + 2 * s.n_groups * s.d_state
        nh = di // s.head_dim
        mamba = (d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                 + s.d_conv * conv_dim + di * d)
        total = l * mamba
        if cfg.shared_attn_every:
            total += attn + ffn_params(cfg.d_ff)   # ONE shared block
    else:
        per_layer += ffn_params(cfg.d_ff)
        total = l * per_layer
    if cfg.encoder_layers:
        enc = cfg.encoder_layers * (attn + ffn_params(cfg.d_ff))
        xattn = l * attn                            # decoder cross-attn
        total = total + enc + xattn
    # embeddings
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return float(total + emb)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_detail: dict
    model_flops_total: float
    hlo_flops_total: float
    useful_ratio: float          # MODEL_FLOPS / counted FLOPs (waste probe)
    dominant: str
    roofline_fraction: float     # useful flops vs dominant-term-limited peak
    chips: int

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d


def roofline_terms(flops: float, byt: float, coll: dict, cfg: ArchConfig,
                   shape: ShapeSpec, chips: int, hw: HW = DEFAULT_HW,
                   n_active: Optional[float] = None) -> RooflineTerms:
    cb = float(coll["total"])

    compute_s = flops / hw.peak_flops
    memory_s = byt / hw.hbm_bw
    if hw.nvlink_bw is None:
        collective_s = cb / hw.ici_bw
    else:                                   # two tiers (module docstring)
        collective_s = (float(coll.get("nvlink_bytes", cb)) / hw.nvlink_bw
                        + float(coll.get("network_bytes", 0)) / hw.ici_bw)

    mf = model_flops(cfg, shape, n_active=n_active)
    hlo_total = flops * chips
    useful = mf / hlo_total if hlo_total else 0.0

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    dom_s = terms[dominant]
    frac = (mf / (dom_s * hw.peak_flops * chips)) if dom_s > 0 else 0.0
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        flops_per_chip=flops, bytes_per_chip=byt,
        collective_bytes_per_chip=cb, collective_detail=coll,
        model_flops_total=mf, hlo_flops_total=hlo_total, useful_ratio=useful,
        dominant=dominant, roofline_fraction=frac, chips=chips)


# ---------------------------------------------------------------------------
# the step counter
# ---------------------------------------------------------------------------

# ops that move no data: allocation without a write, aliases, and reading
# a shape or a scalar back
_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "lift_fresh", "detach", "alias", "_local_scalar_dense",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
               "is_same_size", "_has_compatible_shallow_copy_type"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.layout, torch.memory_format)


def _signature(x):
    """(hashable key, whether ``x`` holds tensors and every one is
    ``meta``), or None when ``x`` holds something that cannot key a
    cache."""
    meta = [None]

    def sig(v):
        if isinstance(v, torch.Tensor):
            meta[0] = v.is_meta and meta[0] is not False
            return ("T", tuple(v.shape), v.stride(), v.dtype)
        if isinstance(v, (list, tuple)):
            return tuple(sig(u) for u in v)
        if isinstance(v, dict):
            return tuple((k, sig(u)) for k, u in sorted(v.items()))
        if isinstance(v, _HASHABLE) or hasattr(v, "_overloadpacket"):
            return v
        raise TypeError
    try:
        key = sig(x)
        hash(key)
    except TypeError:
        return None
    return key, bool(meta[0])


def _spec(out):
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and all(
            isinstance(t, torch.Tensor) for t in out):
        return ("L", type(out), tuple(_spec(t) for t in out))
    return None


def _rebuild(spec):
    if spec[0] == "T":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3],
                                   device="meta")
    return spec[1](_rebuild(s) for s in spec[2])


class StepCounter(TorchDispatchMode):
    """Counts the aten ops of a step run under it (module docstring):
    ``flops``, ``bytes``, ``peak_bytes`` (live bytes the step allocated,
    at their most), ``ops`` and, with ``sites``, the result bytes of each
    op of at least ``min_site_bytes`` by ``(aten op, model call site)``
    (``roofline/inspect.py``'s memory census).  Works on ``meta`` tensors
    (the dry-run) and on CUDA tensors (the calibration) alike."""

    def __init__(self, sites: bool = False, min_site_bytes: int = 1 << 20):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak_bytes = 0
        self.by_op: dict = {}
        self.sites = {} if sites else None
        self.min_site_bytes = min_site_bytes
        self._meta_cache: dict = {}

    def _free(self, n: int) -> None:
        self.live -= n

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on ``meta`` inputs, a functional op
        seen before with the same input shapes, strides, dtypes and
        arguments gets fresh ``meta`` outputs of the shapes it gave then,
        without running its meta kernel again (the kernels are Python and
        dominate a dry-run's time; a time loop repeats the same ops)."""
        key = None
        if (func.namespace == "aten" and not func.is_view
                and not func._schema.is_mutable and "device" not in kwargs):
            key = _signature((func, args, kwargs))
        if key is not None and key[1]:
            spec = self._meta_cache.get(key)
            if spec is not None:
                return _rebuild(spec)
        out = func(*args, **kwargs)
        if key is not None and key[1]:
            spec = _spec(out)
            if spec is not None:
                self._meta_cache[key] = spec
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if func.namespace != "aten":
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = packet.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        schema = func._schema
        written = {i for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write}
        read = 0
        for i, a in enumerate(args):
            if i not in written:
                read += sum(_nbytes(t) for t in _tensors(a))
        for k, a in kwargs.items():
            read += sum(_nbytes(t) for t in _tensors(a))
        outs = list(_tensors(out))
        wrote = sum(_nbytes(t) for t in outs)
        self.bytes += read + wrote
        self.by_op[name] = self.by_op.get(name, 0) + read + wrote
        if not written and not name.endswith("_"):   # fresh storage
            for t in outs:
                n = _nbytes(t)
                if n:
                    self.live += n
                    weakref.finalize(t, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live)
        if self.sites is not None and wrote >= self.min_site_bytes:
            from repro_torch.launch.collectives import call_site
            key = (name, call_site())
            self.sites[key] = self.sites.get(key, 0) + wrote
        return out

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes, "ops": self.ops}
