"""Traffic reports and config diffs for an engine (``GNSEngine.describe``;
port of ``repro.gns.describe``).

The host-side half of the reference module: :func:`traffic_report` (the
record ``describe`` returns without a mesh) and the diff mode
(:func:`diff_records`, :func:`diff`).  The reference's mesh half lowers the
train step for a TPU mesh (``batch_structs``, ``describe_lowering``,
``placement_traffic_sim``); it has no counterpart here.
"""
from __future__ import annotations

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
