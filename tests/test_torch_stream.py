"""Port parity of streaming ingest through the store and the engine.

* The store's delta hooks: a reference store and a port store get the same
  graph, features, config (two shards, locality placement, adaptive
  policy), the same per-group traffic and the same temporal events; after
  each synchronous ``refresh()`` the merged graph, features and labels,
  the live generation's membership, slots, placement and table, and the
  ``merges_applied`` / ``rows_migrated`` counters are equal.
* The engine's ingest surface: after ``merge_deltas()``, ``infer`` on the
  same ids (new nodes among them) agrees with the reference's within rtol
  1e-4 / atol 1e-4 (the reference's parameters carried over; K1 and K2 in
  their plain versions here, Pallas interpret mode there).
* Checkpoints with pending deltas restore in the other package to the same
  staged ops and seqs, both ways.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import jax_params_to_numpy  # noqa: E402
from repro.data import temporal_event_stream as temporal_ref  # noqa: E402
from repro.featurestore import CacheConfig as CacheConfigRef  # noqa: E402
from repro.featurestore import FeatureStore as FeatureStoreRef  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.gns.config import StreamConfig as StreamConfigRef  # noqa: E402
from repro.graph.datasets import get_dataset as get_dataset_ref  # noqa: E402
from repro.stream import DeltaBuffer as DeltaBufferRef  # noqa: E402
from repro_torch.data import temporal_event_stream  # noqa: E402
from repro_torch.featurestore import CacheConfig, FeatureStore  # noqa: E402
from repro_torch.gns import EngineConfig, GNSEngine  # noqa: E402
from repro_torch.gns.config import StreamConfig  # noqa: E402
from repro_torch.graph.datasets import get_dataset  # noqa: E402
from repro_torch.models.graphsage import params_from_numpy  # noqa: E402
from repro_torch.stream import DeltaBuffer  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _stores():
    ds_ref, ds = get_dataset_ref("tiny", seed=0), get_dataset("tiny", seed=0)
    kw = dict(fraction=0.1, strategy="adaptive", placement="locality",
              shards=2)
    ref = FeatureStoreRef(ds_ref.features, ds_ref.graph, CacheConfigRef(**kw),
                          train_idx=ds_ref.train_idx, build_adjacency=True,
                          seed=0)
    port = FeatureStore(ds.features, ds.graph, CacheConfig(**kw),
                        device="cpu", train_idx=ds.train_idx,
                        build_adjacency=True, seed=0)
    for store, buf_cls, scfg_cls, d in ((ref, DeltaBufferRef,
                                         StreamConfigRef, ds_ref),
                                        (port, DeltaBuffer, StreamConfig,
                                         ds)):
        store.labels = d.labels
        store.attach_stream(buf_cls(d.graph.num_nodes, d.feat_dim),
                            scfg_cls(merge_min_pending=1))
    return ref, port, ds


def _traffic(store, rng_seed, rounds=3):
    """Per-group requests through ``assemble_input`` (the adaptive
    policy's miss EMA and the placement histograms both observe them)."""
    rng = np.random.default_rng(rng_seed)
    gen = store.generation
    v = store.graph.num_nodes
    for _ in range(rounds):
        for group in (0, 1):
            lo = 0 if group == 0 else v // 2
            ids = rng.integers(lo, lo + v // 2, 64).astype(np.int64)
            store.assemble_input(gen, ids, len(ids) - 8, group=group)


def _assert_stores_equal(ref, port):
    np.testing.assert_array_equal(ref.graph.indptr, port.graph.indptr)
    np.testing.assert_array_equal(ref.graph.indices, port.graph.indices)
    np.testing.assert_array_equal(np.asarray(ref.features), port.features)
    np.testing.assert_array_equal(ref.labels, port.labels)
    gr, gp = ref.generation, port.generation
    assert gr.version == gp.version
    np.testing.assert_array_equal(gr.state.node_ids, gp.state.node_ids)
    np.testing.assert_array_equal(gr.state.slot_of, gp.state.slot_of)
    pr, pp = gr.state.placement, gp.state.placement
    assert (pr is None) == (pp is None)
    if pr is not None:
        np.testing.assert_array_equal(pr.device_row_of_slot,
                                      pp.device_row_of_slot)
    np.testing.assert_array_equal(np.asarray(gr.table), gp.table.numpy())
    assert gr.graph.num_nodes == gp.graph.num_nodes == port.graph.num_nodes
    assert (ref.merges_applied, ref.rows_migrated, ref.pending_deltas()) == \
        (port.merges_applied, port.rows_migrated, port.pending_deltas())
    assert ref.meter.bytes_delta_upload == port.meter.bytes_delta_upload


def test_store_generations_match_reference_across_merges():
    ref, port, ds = _stores()
    ref.refresh(version=0)
    port.refresh(version=0)
    _assert_stores_equal(ref, port)
    events = temporal_event_stream(ds, num_batches=3, events_per_batch=40,
                                   new_node_frac=0.1, seed=5)
    for k, ev in enumerate(events, start=1):
        for store in (ref, port):
            _traffic(store, 100 + k)
            if ev.node_feats is not None:
                store._stream.add_nodes(ev.node_feats, ev.node_labels)
            store._stream.add_edges(ev.src, ev.dst)
            if k == 2:               # a delete of an edge that exists
                u = int(np.flatnonzero(store.graph.degrees)[0])
                store._stream.delete_edges(
                    [u], [int(store.graph.neighbors(u)[0])])
            assert store.stream_merge_due()
        ref.refresh(version=k)
        port.refresh(version=k)
        _assert_stores_equal(ref, port)
        assert port.merges_applied == k
        assert port.graph.num_nodes == ds.graph.num_nodes + sum(
            e.num_new_nodes for e in list(events)[:k])
    # the incremental re-solve ran (pins from the previous solve)
    assert port._placement_sig is not None
    assert not port.stream_merge_due()


def test_routing_table_follows_the_merge():
    """After a merge the table covers the grown id space; a router holding
    the pre-merge table treats the new ids as unowned."""
    _, port, ds = _stores()
    port.refresh(version=0)
    old = port.routing_table()
    new_ids = port._stream.add_nodes(np.ones((3, ds.feat_dim), np.float32))
    port._stream.add_edges(new_ids, [0, 1, 2])
    port.refresh(version=1)
    table = port.routing_table()
    assert len(table.shard_of_node) == ds.graph.num_nodes + 3
    np.testing.assert_array_equal(old.owners(new_ids), [-1, -1, -1])
    assert table.owners(new_ids).shape == (3,)


@pytest.mark.parametrize("hook", ["refresh_delay", "upload_delay"])
def test_delay_hooks_hold_an_async_build_open(hook):
    """The store's test hooks stretch an async build (before its upload,
    or inside it): the merging build is in flight and nothing swaps until
    it ends, then the merge publishes whole."""
    _, port, ds = _stores()
    port.refresh(version=0)
    setattr(port, hook, 0.3)
    new = port._stream.add_nodes(np.ones((1, ds.feat_dim), np.float32))
    port._stream.add_edges(new, [0])
    assert port.begin_refresh(version=1)
    assert port.refreshing and not port.swap_if_ready()
    assert port.generation.graph.num_nodes == ds.graph.num_nodes
    assert port.wait_refresh(timeout=60)
    assert port.version == 1 and port.merges_applied == 1
    assert port.generation.graph.num_nodes == ds.graph.num_nodes + 1


def _engine_cfg_json() -> str:
    """A small stream config in the reference's JSON: two shards, locality
    placement, adaptive policy, fused K1 input and K2 aggregation."""
    from repro.core.sampler import SamplerConfig
    from repro.gns.config import DataConfig, ModelConfig, ServeConfig
    scfg = SamplerConfig(fanouts=(3, 4), batch_size=32,
                         cache=CacheConfigRef(fraction=0.1,
                                              strategy="adaptive",
                                              placement="locality",
                                              shards=2))
    cfg = EngineConfigRef(
        sampler="gns", data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=scfg.cache,
        model=ModelConfig(hidden_dim=32, aggregate_impl="pallas",
                          input_impl="fused"),
        serve=ServeConfig(buckets=(8, 32), max_wait_ms=2.0),
        stream=StreamConfigRef(merge_min_pending=1), seed=0)
    return json.dumps(cfg.to_dict())


def _engines():
    """A reference and a port engine from the same JSON, on fresh datasets
    (merges re-point an engine's dataset), with the same parameters."""
    text = _engine_cfg_json()
    ref = EngineRef(EngineConfigRef.from_dict(json.loads(text)),
                    dataset=get_dataset_ref("tiny", seed=0))
    port = GNSEngine(EngineConfig.from_dict(json.loads(text)), device="cpu")
    port.params = params_from_numpy(jax_params_to_numpy(ref.params),
                                    device="cpu")
    return ref, port


def test_engine_infer_after_merge_matches_reference():
    ref, port = _engines()
    assert port.describe()["stream"]["enabled"]
    for eng in (ref, port):
        eng.ensure_cache()
    v0 = port.ds.graph.num_nodes
    ids = np.random.default_rng(1).choice(v0, 20, replace=False)
    np.testing.assert_allclose(port.infer(ids), ref.infer(ids), **TOL)
    stream = temporal_ref(ref.ds, num_batches=2, events_per_batch=30,
                          new_node_frac=0.1, seed=7)
    for eng in (ref, port):
        for ev in stream:
            eng.ingest_events(ev)
        eng.ingest(ids[:2], ids[2:4], op="delete")
    assert ref.pending_deltas == port.pending_deltas > 0
    ref.merge_deltas()
    port.merge_deltas()
    assert port.pending_deltas == 0 and port.store.merges_applied == 1
    assert port.ds.graph.num_nodes == v0 + stream.total_new_nodes
    np.testing.assert_array_equal(ref.ds.graph.indptr, port.ds.graph.indptr)
    np.testing.assert_array_equal(ref.ds.graph.indices,
                                  port.ds.graph.indices)
    assert port.sampler.g is port.ds.graph      # adopted with the generation
    new = np.arange(v0, v0 + stream.total_new_nodes)
    query = np.concatenate([new, ids])
    got, want = port.infer(query), ref.infer(query)
    assert got.shape == (len(query), port.ds.num_classes)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    rec, rec_ref = port.describe()["stream"], ref.describe()["stream"]
    assert rec == rec_ref
    assert rec["merges_applied"] == 1 and rec["pending_deltas"] == 0


def _stage_mixed(eng):
    """Inserts, a conflicting delete, new nodes and edges to them."""
    eng.ingest([1, 2, 3], [4, 5, 6])
    eng.ingest([1], [4], op="delete")
    new = eng.ingest_nodes(np.arange(2 * eng.ds.feat_dim, dtype=np.float32)
                           .reshape(2, eng.ds.feat_dim),
                           labels=np.array([3, 1]))
    eng.ingest(new, [0, 7])


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_checkpoint_with_pending_deltas_cross_loads(saver, tmp_path):
    ref, port = _engines()
    src, dst = (ref, port) if saver == "reference" else (port, ref)
    _stage_mixed(src)
    want = src.stream.state()
    src.save(tmp_path / "ckpt", step=4)
    assert dst.restore(tmp_path / "ckpt") == 4
    got = dst.stream.state()
    assert want.keys() == got.keys()
    for k in want:
        assert np.asarray(want[k]).dtype == np.asarray(got[k]).dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert dst.pending_deltas == src.pending_deltas == 8
    # merging the restored log gives the saver's merged structure
    src.merge_deltas()
    dst.merge_deltas()
    np.testing.assert_array_equal(src.ds.graph.indptr, dst.ds.graph.indptr)
    np.testing.assert_array_equal(src.ds.graph.indices, dst.ds.graph.indices)
    np.testing.assert_array_equal(np.asarray(src.ds.labels),
                                  np.asarray(dst.ds.labels))
