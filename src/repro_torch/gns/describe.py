"""Traffic reports and config diffs for an engine (``GNSEngine.describe``;
port of ``repro.gns.describe``).

:func:`traffic_report` (the record ``describe`` returns), the mesh
record :func:`mesh_report`, :func:`placement_traffic_sim` (the locality
placement's cross-shard traffic on synthetic skewed demand), the lowering
record :func:`describe_lowering` (what ``launch/dryrun_gnn.py`` prints)
and the diff mode (:func:`diff_records`, :func:`diff`).

Where the reference lowers and compiles the engine's train step for a
mesh, :func:`describe_lowering` runs it: this rank's step
(``gns.engine.make_train_step``, the function the engine runs) on
``meta`` tensors of this rank's shapes (:func:`batch_structs`: its data-
parallel group's batch, its shard of the cache table), counted op by op
(``roofline/analysis.py::StepCounter``) with its collectives recorded
(``launch/collectives.py``).  K1 and K3 run their plain versions there
(``input_kernel="reference"``, as the reference lowers them): a ``meta``
tensor launches no kernel.

``fast_path`` selects what the input layer runs: ``"dynamic"`` (the
engine's per-group home-shard vector, counted with no home shard: every
shard runs its partial and the group sums them), ``"static"`` (home shard
0: its owner claims every lane and broadcasts the rows) or ``"off"``
(the plain per-shard sum, no locality gate).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.minibatch import block_pad_sizes
from repro_torch.featurestore import FeatureStore
from repro_torch.optim.adam import AdamConfig


def traffic_report(*, num_nodes: int, feat_dim: int, cache_frac: float,
                   batch: int, fanouts, n_shards: int = 1,
                   meter=None, backend: str = "host") -> dict:
    """Host-side record: no mesh, no lowering.

    ``backend="device"`` reports the device-resident sampling path: the
    input block degenerates to its dst rows (the layer-0 neighbor lanes are
    drawn inside the step against the generation's cache_adj CSR), so the
    per-batch input rows — and the worst-case streamed bytes — shrink by
    the (1 + k0) input-fanout factor.  ``input_rows_per_batch`` is the
    node-wise chain's pad for every host sampler, LADIES's too, as in the
    reference.
    """
    cache_rows = FeatureStore.padded_rows(num_nodes, cache_frac,
                                          multiple=max(n_shards, 1))
    table_bytes = cache_rows * feat_dim * 4
    pads = block_pad_sizes(batch, fanouts)
    s0 = pads[0][0] if backend == "device" else pads[0][1]
    rec = {
        "arch": "gnn-graphsage-gns", "status": "ok", "mesh": None,
        "sampler_backend": backend,
        "cache_rows": cache_rows, "cache_table_bytes": table_bytes,
        "input_rows_per_batch": s0,
        "streamed_bytes_per_batch_worstcase": s0 * feat_dim * 4,
    }
    if meter is not None:
        rec["meter"] = meter.breakdown()
    return rec


def placement_traffic_sim(cache_rows: int, n_shards: int, n_groups: int,
                          dominant_share: float = 0.8,
                          seed: int = 0) -> dict:
    """Cross-shard lookup traffic, contiguous vs locality, at ``cache_rows``.

    Runs the REAL placement solver (``featurestore.placement``) on a
    synthetic Zipf demand histogram: each cached row's traffic is
    Zipf-distributed and ``dominant_share`` of it comes from one
    uniformly-drawn DP group — the skew Data Tiering (arXiv:2111.05894)
    reports for real access traces.  Reports the fraction of hit traffic
    served by the requesting group's home shard under both placements.
    """
    from repro_torch.featurestore.placement import _assign, home_shard

    rng = np.random.default_rng(seed)
    rows_per_shard = cache_rows // n_shards
    total = rng.zipf(1.5, cache_rows).astype(np.float64)
    dom = rng.integers(0, n_groups, cache_rows)
    # per-(group, row) traffic without materializing [G, R] for the metric:
    # dominant group carries dominant_share, the rest spread evenly
    rest = total * (1.0 - dominant_share) / max(n_groups - 1, 1)
    pref = np.array([home_shard(g, n_shards) for g in range(n_groups)])[dom]

    # contiguous: shard of a slot is slot // rows_per_shard (membership is
    # traffic-agnostic, so hot rows land uniformly across shards)
    def local_traffic(shard_of_slot):
        local = np.zeros(cache_rows)
        for g in range(n_groups):
            mine = dom == g
            share = np.where(mine, dominant_share * total, rest)
            local += share * (shard_of_slot == home_shard(g, n_shards))
        return float(local.sum())

    grand = float(total.sum())
    contiguous = np.arange(cache_rows) // rows_per_shard
    # locality: the real greedy solver on (total, preferred shard) — the
    # code path FeatureStore._solve_placement runs, via the same internal
    # assignment
    locality, _ = _assign(total, pref, n_shards, rows_per_shard, seed=seed)
    frac_cont = local_traffic(contiguous) / grand
    frac_loc = local_traffic(locality) / grand
    return {
        "lookup_local_frac_contiguous": round(frac_cont, 4),
        "lookup_local_frac_locality": round(frac_loc, 4),
        "crossshard_rows_frac_contiguous": round(1 - frac_cont, 4),
        "crossshard_rows_frac_locality": round(1 - frac_loc, 4),
    }


def mesh_report(*, data: int, model: int, cache_rows: int, feat_dim: int,
                n_groups: int, bytes_per_el: int = 4) -> dict:
    """The ``"mesh"`` record of an engine on a ``(data, model)`` mesh: the
    cache's shards (one per ``model`` rank), rows per shard, the bytes each
    rank uploads per generation against a replicated upload, and
    :func:`placement_traffic_sim` at this cache's rows."""
    shards = model
    rps = cache_rows // shards
    rec = {"data": data, "model": model, "ranks": data * model,
           "shards": shards, "rows_per_shard": rps,
           "upload_bytes_per_rank": rps * feat_dim * bytes_per_el,
           "upload_bytes_per_rank_replicated":
               cache_rows * feat_dim * bytes_per_el}
    if shards > 1:
        rec["placement_sim"] = placement_traffic_sim(cache_rows, shards,
                                                     n_groups)
    return rec


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_structs(mesh, batch: int, fanouts, feat_dim: int, cache_axis=None,
                  backend: str = "host") -> tuple:
    """(``meta`` DeviceBatch, home-shard vector) of this rank's data-
    parallel group: ``batch`` is the global target count, one minibatch
    per group, so the block pads are the per-group batch's
    (``batch // groups``), as the engine samples them.  ``backend=
    "device"``: the device sampler's batch (the placeholder input block,
    one dead lane, plus the fallback lanes and the draw key)."""
    from repro_torch.core.minibatch import DeviceBatch, LayerBlock
    from repro_torch.kernels.ops import dp_group_count
    groups = dp_group_count(mesh, cache_axis)
    if batch % groups:
        raise ValueError(f"batch {batch} over {groups} groups")
    pads = block_pad_sizes(batch // groups, fanouts)
    device = backend == "device"
    blocks = []
    for li, (d, s) in enumerate(pads):
        if li == 0 and device:
            k, s = 1, d              # placeholder input block (device draw)
        else:
            k = fanouts[li]
        blocks.append(LayerBlock(nbr_idx=_meta((d, k), torch.int32),
                                 nbr_w=_meta((d, k)), dst_mask=_meta((d,)),
                                 num_src=s, num_dst=d))
    s0 = pads[0][0] if device else pads[0][1]
    k0 = fanouts[0]
    b = batch // groups
    struct = DeviceBatch(
        blocks=tuple(blocks), input_cache_slots=_meta((s0,), torch.int32),
        input_streamed=_meta((s0, feat_dim)), input_mask=_meta((s0,)),
        labels=_meta((b,), torch.int32), label_mask=_meta((b,)),
        input_fb_rows=_meta((s0, k0), torch.int32) if device else None,
        input_fb_w=_meta((s0, k0)) if device else None,
        sample_key=np.zeros((1, 2), np.uint32) if device else None)
    return struct, np.full(groups, -1, np.int32)


def describe_lowering(*, mesh, num_nodes: int, feat_dim: int,
                      num_classes: int, cache_frac: float, batch: int,
                      fanouts, hidden_dim: int = 256,
                      input_impl: str = "fused",
                      input_kernel: str = "reference",
                      fast_path: str = "dynamic",
                      backend: str = "host",
                      sample_kernel: str = "reference",
                      avg_degree: int = 16,
                      optim: AdamConfig = None) -> dict:
    """Run and count this rank's engine train step on ``mesh`` (module
    docstring); return the record, the reference's keys with ``count_s``
    for its ``compile_s``.

    ``batch`` is global (one minibatch per data-parallel group).
    ``backend="device"`` counts the device-sampling step: the batch
    carries the placeholder input block, the fallback lanes and the draw
    key, a replicated ``DeviceCacheAdj`` (``avg_degree`` sizes its
    indices capacity) feeds the draw, and the input rows and streamed
    bytes shrink by the (1 + k0) factor the device draw removes.
    """
    from repro_torch.gns.engine import make_train_step
    from repro_torch.kernels.ops import dp_group_count
    from repro_torch.launch.collectives import recording
    from repro_torch.launch.mesh import cache_shard_axis
    from repro_torch.models import graphsage
    from repro_torch.optim.adam import AdamW
    from repro_torch.roofline.analysis import (StepCounter,
                                               collective_bytes,
                                               roofline_terms)

    if fast_path not in ("dynamic", "static", "off"):
        raise ValueError(fast_path)
    chips = mesh.size
    cache_axis = cache_shard_axis(mesh)
    groups = dp_group_count(mesh, cache_axis)
    mcfg = graphsage.SageConfig(feat_dim=feat_dim, hidden_dim=hidden_dim,
                                num_classes=num_classes,
                                num_layers=len(fanouts),
                                input_impl=input_impl,
                                sample_kernel=sample_kernel,
                                cache_shard_axis=cache_axis)
    opt = AdamW(optim or AdamConfig(lr=3e-3))
    n_shards = mesh.shape[cache_axis]
    cache_rows = FeatureStore.padded_rows(num_nodes, cache_frac,
                                          multiple=n_shards)
    params = {"layers": []}
    in_dim = feat_dim
    for i in range(len(fanouts)):
        out_dim = num_classes if i == len(fanouts) - 1 else hidden_dim
        params["layers"].append({"w": _meta((2 * in_dim, out_dim)),
                                 "b": _meta((out_dim,))})
        in_dim = out_dim
    opt_state = opt.init(params)
    cache = _meta((cache_rows // n_shards, feat_dim))   # this rank's shard
    b_struct, home = batch_structs(mesh, batch, fanouts, feat_dim,
                                   cache_axis, backend=backend)
    adj = None
    if backend == "device":
        from repro_torch.sampling.adjacency import DeviceCacheAdj
        nnz = max(1024, cache_rows * avg_degree)
        cap = 1 << (nnz - 1).bit_length()
        adj = DeviceCacheAdj(indptr=_meta((cache_rows + 1,), torch.int32),
                             indices=_meta((cap,), torch.int32),
                             deg=_meta((cache_rows,)),
                             hitp=_meta((cache_rows,)))
    local = {"dynamic": home, "static": 0, "off": None}[fast_path]
    step = make_train_step(mcfg, opt, mesh)
    counter = StepCounter()
    t0 = time.time()
    with recording() as log, counter:
        step(params, opt_state, b_struct, cache, local, adj)
    t_count = time.time() - t0
    coll = collective_bytes(log)

    n_params = float(sum(t.numel() for layer in params["layers"]
                         for t in layer.values()))
    flops, byt = float(counter.flops), float(counter.bytes)
    shape = ShapeSpec("train_1k", 1, batch, "train")   # D = batch targets
    terms = roofline_terms(flops, byt, coll, _gnn_cfg_stub(), shape, chips,
                           n_active=n_params)
    table_bytes = cache_rows * feat_dim * 4
    n_dp_groups = max(chips // n_shards, 1)
    placement_sim = placement_traffic_sim(cache_rows, n_shards,
                                          min(n_dp_groups, 64))
    pads0 = block_pad_sizes(batch // groups, fanouts)[0]
    s0_rows = groups * (pads0[0] if backend == "device" else pads0[1])
    row_bytes = feat_dim * 4
    def nbytes(*trees) -> float:
        out = 0.0
        for tree in trees:
            if isinstance(tree, torch.Tensor):
                out += tree.numel() * tree.element_size()
            elif isinstance(tree, dict):
                out += nbytes(*tree.values())
            elif isinstance(tree, (list, tuple)):
                out += nbytes(*tree)
            elif hasattr(tree, "__dataclass_fields__"):
                out += nbytes(*(getattr(tree, f) for f in
                                tree.__dataclass_fields__))
        return out
    arg_bytes = nbytes(params, opt_state, b_struct, cache, adj)
    return {
        "arch": "gnn-graphsage-gns", "shape": "train_1k",
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "chips": chips,
        "status": "ok", "kind": "train",
        "sampler_backend": backend,
        "input_rows_per_batch": s0_rows,
        "input_impl": mcfg.input_impl, "input_kernel": input_kernel,
        "cache_shard_axis": cache_axis,
        "dp_groups": groups,
        "fast_path": fast_path,
        "local_fast_path": fast_path != "off",
        "params_total": n_params,
        "cache_rows": cache_rows,
        "cache_bytes_per_chip": table_bytes / n_shards,
        # per-generation refresh transfer: shard-aware upload vs
        # replicating the full table to every chip
        "upload_bytes_per_gen_sharded": table_bytes * chips // n_shards,
        "upload_bytes_per_gen_replicated": table_bytes * chips,
        # locality placement: the fraction of cache-hit rows the group's
        # home shard serves, and the implied cross-shard row bytes per
        # batch, contiguous vs locality
        **placement_sim,
        "crossshard_bytes_per_batch_contiguous": int(
            s0_rows * row_bytes *
            placement_sim["crossshard_rows_frac_contiguous"]),
        "crossshard_bytes_per_batch_locality": int(
            s0_rows * row_bytes *
            placement_sim["crossshard_rows_frac_locality"]),
        "memory_analysis": {"argument_bytes": arg_bytes,
                            "temp_bytes": counter.peak_bytes},
        "cost_flops_per_device": flops, "cost_bytes_per_device": byt,
        "roofline": terms.as_dict(), "count_s": round(t_count, 2),
    }


def _gnn_cfg_stub():
    """Minimal cfg for roofline_terms' model_flops (n_active overrides)."""
    return ArchConfig(name="gnn", family="gnn", num_layers=3, d_model=256,
                      num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=1)


# ---------------------------------------------------------------------------
# diff mode: compare two configs' traffic records
# ---------------------------------------------------------------------------

# keys that vary run-to-run without the configuration changing: wall-clock
# measurements, per-process memory analysis, and streaming-ingest run state
# (staged/merged/migrated counts) have no place in a diff
_VOLATILE = ("compile_s", "count_s", "memory_analysis", "meter",
             "pending_deltas", "merges_applied", "rows_migrated")


def _flatten(d: dict, prefix: str = "") -> dict:
    """Nested dict -> {dotted.key: leaf}, volatile keys dropped."""
    out = {}
    for k, v in d.items():
        if k in _VOLATILE:
            continue
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=key + "."))
        else:
            out[key] = v
    return out


def diff_records(rec_a: dict, rec_b: dict) -> dict:
    """Structural diff of two describe records (or any nested dicts).

    Returns ``{"only_a": {...}, "only_b": {...}, "changed": {key: [a, b]},
    "same": bool}`` over dotted leaf keys, with run-volatile keys
    (compile wall time, memory analysis, live meter readings) excluded so
    two runs of the SAME config diff as identical.
    """
    fa, fb = _flatten(rec_a), _flatten(rec_b)
    changed = {k: [fa[k], fb[k]] for k in sorted(fa.keys() & fb.keys())
               if fa[k] != fb[k]}
    only_a = {k: fa[k] for k in sorted(fa.keys() - fb.keys())}
    only_b = {k: fb[k] for k in sorted(fb.keys() - fa.keys())}
    return {"only_a": only_a, "only_b": only_b, "changed": changed,
            "same": not (changed or only_a or only_b)}


def diff(cfg_a, cfg_b, *, dataset_a=None, dataset_b=None,
         device=None) -> dict:
    """Compare two :class:`~repro_torch.gns.EngineConfig` runs end to end.

    Builds the engine for each config on ``device`` (``None``: the GPU;
    ``dataset_*`` shortcut concrete datasets, e.g. in tests) and diffs both
    layers:

    * ``config`` — the declarative fields themselves (what the operator
      changed);
    * ``record`` — each config's ``GNSEngine.describe()`` traffic record
      (what that change did to cache rows, table bytes, input rows ...).
    """
    from repro_torch.gns.engine import GNSEngine

    rec_a = GNSEngine(cfg_a, dataset=dataset_a, device=device).describe()
    rec_b = GNSEngine(cfg_b, dataset=dataset_b, device=device).describe()
    out = {
        "config": diff_records(cfg_a.to_dict(), cfg_b.to_dict()),
        "record": diff_records(rec_a, rec_b),
    }
    out["same"] = out["config"]["same"] and out["record"]["same"]
    return out
