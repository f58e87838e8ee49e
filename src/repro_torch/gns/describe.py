"""Traffic reports and config diffs for an engine (``GNSEngine.describe``;
port of ``repro.gns.describe``).

The host-side half of the reference module: :func:`traffic_report` (the
record ``describe`` returns), :func:`placement_traffic_sim` (the locality
placement's cross-shard traffic on synthetic skewed demand), the mesh
record :func:`mesh_report` and the diff mode (:func:`diff_records`,
:func:`diff`).  The reference's lowering of the train step for a TPU mesh
(``batch_structs``, ``describe_lowering``) has no counterpart here.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.minibatch import block_pad_sizes
from repro_torch.featurestore import FeatureStore


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


# ---------------------------------------------------------------------------
# diff mode: compare two configs' traffic records
# ---------------------------------------------------------------------------

# keys that vary run-to-run without the configuration changing: wall-clock
# measurements, per-process memory analysis, and streaming-ingest run state
# (staged/merged/migrated counts) have no place in a diff
_VOLATILE = ("compile_s", "memory_analysis", "meter",
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
