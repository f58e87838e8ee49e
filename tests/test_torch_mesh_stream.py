"""Streaming ingest and checkpoints on a (1, 2) mesh: two ``gloo`` ranks
spawned once by ``repro_torch.launch.mesh.run_ranks`` for every test here.
The leader (rank 0) stages the deltas; at each generation's kickoff it
drains them and every rank merges the same batch.

The oracle is the reference WITHOUT a mesh and with 2 cache shards (the
reference's own mesh smokes fail on jax 0.9, ROADMAP Queue C):

* a store's generations across three merges of the same traffic and
  temporal events: the merged graph, features and labels, the members,
  slots, placement and version bit for bit, each rank holding its shard's
  rows of the table, the same merge counters and the same id and seq
  clocks on every rank;
* the reference's stream smoke through a 2-worker fabric: a pre-merge
  batch replays bit for bit, a new node is served, nothing is left
  pending, and every rank ends on the same generation;
* checkpoints with pending deltas cross-load both ways: a mesh checkpoint
  restores into the reference and into a one-rank port engine, and theirs
  into the mesh, with the same parameters, delta log and merged structure;
* a follower's ``ingest_nodes`` raises ``NotLeader``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_mesh_ranks import stage_mixed, store_traffic  # noqa: E402
from _torch_parity import jax_params_to_numpy  # noqa: E402
from repro.featurestore import CacheConfig as CacheConfigRef  # noqa: E402
from repro.featurestore import FeatureStore as FeatureStoreRef  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.gns.config import StreamConfig as StreamConfigRef  # noqa: E402
from repro.graph.datasets import get_dataset as get_dataset_ref  # noqa: E402
from repro.stream import DeltaBuffer as DeltaBufferRef  # noqa: E402
from repro_torch.data import temporal_event_stream  # noqa: E402
from repro_torch.gns import EngineConfig, GNSEngine  # noqa: E402
from repro_torch.graph.datasets import get_dataset  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

SPAWN_S = 300


def _cfg_json(smoke: bool) -> str:
    """Two shards, locality placement, adaptive policy, the fused K1 input
    and the K2 aggregation, streaming ingest armed; ``smoke``: the
    reference stream smoke's (5% cache, width 16), else
    ``test_torch_stream``'s engine config."""
    from repro.core.sampler import SamplerConfig
    from repro.gns.config import DataConfig, ModelConfig, ServeConfig
    cache = CacheConfigRef(fraction=0.05 if smoke else 0.1,
                           strategy="adaptive", placement="locality",
                           shards=2)
    scfg = SamplerConfig(fanouts=(3, 4), batch_size=32, cache=cache)
    cfg = EngineConfigRef(
        sampler="gns", data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=cache,
        model=ModelConfig(hidden_dim=16 if smoke else 32,
                          aggregate_impl="pallas", input_impl="fused"),
        serve=ServeConfig(buckets=(8, 32), max_wait_ms=2.0),
        stream=StreamConfigRef(merge_min_pending=1), seed=0)
    return json.dumps(cfg.to_dict())


def _ref_generations() -> list:
    """The reference store's generations under the ranks' traffic and
    events (``stream_ranks`` part 1)."""
    ds_ref, ds = get_dataset_ref("tiny", seed=0), get_dataset("tiny", seed=0)
    store = FeatureStoreRef(
        ds_ref.features, ds_ref.graph,
        CacheConfigRef(fraction=0.1, strategy="adaptive",
                       placement="locality", shards=2),
        train_idx=ds_ref.train_idx, build_adjacency=True, seed=0)
    store.labels = ds_ref.labels
    store.attach_stream(DeltaBufferRef(ds_ref.graph.num_nodes,
                                       ds_ref.feat_dim),
                        StreamConfigRef(merge_min_pending=1))

    def snap():
        gen = store.generation
        return {"indptr": store.graph.indptr, "indices": store.graph.indices,
                "features": np.asarray(store.features),
                "labels": np.asarray(store.labels), "version": gen.version,
                "node_ids": gen.state.node_ids, "slot_of": gen.state.slot_of,
                "placement": np.asarray(gen.state.placement
                                        .device_row_of_slot)
                if gen.state.placement is not None else None,
                "table": np.asarray(gen.table),
                "gen_nodes": gen.graph.num_nodes,
                "counters": (store.merges_applied, store.rows_migrated,
                             store.pending_deltas()),
                "delta_bytes": store.meter.bytes_delta_upload,
                "clocks": (store._stream.next_node,
                           store._stream._next_seq)}

    store.refresh(version=0)
    out = [snap()]
    events = temporal_event_stream(ds, num_batches=3, events_per_batch=40,
                                   new_node_frac=0.1, seed=5)
    for k, ev in enumerate(events, start=1):
        store_traffic(store, 100 + k)
        if ev.node_feats is not None:
            store._stream.add_nodes(ev.node_feats, ev.node_labels)
        store._stream.add_edges(ev.src, ev.dst)
        if k == 2:
            u = int(np.flatnonzero(store.graph.degrees)[0])
            store._stream.delete_edges([u],
                                       [int(store.graph.neighbors(u)[0])])
        store.refresh(version=k)
        out.append(snap())
    return out


def _engines(text):
    """A reference and a one-rank port engine of the checkpoint config,
    each with the deltas of ``stage_mixed`` pending."""
    ref = EngineRef(EngineConfigRef.from_dict(json.loads(text)),
                    dataset=get_dataset_ref("tiny", seed=0))
    port = GNSEngine(EngineConfig.from_dict(json.loads(text)), device="cpu")
    for eng in (ref, port):
        stage_mixed(eng)
    return ref, port


def _params(eng) -> list:
    if isinstance(eng, GNSEngine):
        return [t.detach().numpy() for layer in eng.params["layers"]
                for t in layer.values()]
    tree = jax_params_to_numpy(eng.params)
    return [a for layer in tree["layers"] for a in layer.values()]


def _merged(eng) -> dict:
    eng.merge_deltas()
    return {"indptr": eng.ds.graph.indptr, "indices": eng.ds.graph.indices,
            "labels": np.asarray(eng.ds.labels)}


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_stream")
    ckpt = _cfg_json(smoke=False)
    ref, port = _engines(ckpt)
    savers = {"reference": ref, "port": port}
    for step, (name, eng) in enumerate(savers.items(), start=4):
        eng.save(root / name, step=step)
    spec = {"smoke_cfg": _cfg_json(smoke=True), "ckpt_cfg": ckpt,
            "dir_mesh": str(root / "mesh"),
            "restore": {name: str(root / name) for name in savers}}
    ranks = run_ranks("_torch_mesh_ranks:stream_ranks", data=1, model=2,
                      devices=["cpu"] * 2, backend="gloo", args=(spec,),
                      timeout_s=SPAWN_S)
    return {"ranks": ranks, "root": root, "ckpt": ckpt, "savers": savers}


def test_store_generations_match_reference_across_merges(streamed):
    want = _ref_generations()
    for rank, r in enumerate(streamed["ranks"]):
        assert r["due"] == [True, True, True, False]
        assert len(r["generations"]) == len(want) == 4
        for k, (got, exp) in enumerate(zip(r["generations"], want)):
            for f in ("indptr", "indices", "features", "labels", "node_ids",
                      "slot_of"):
                np.testing.assert_array_equal(got[f], exp[f],
                                              err_msg=f"{f} at merge {k}")
            assert (got["placement"] is None) == (exp["placement"] is None)
            if exp["placement"] is not None:
                np.testing.assert_array_equal(got["placement"],
                                              exp["placement"])
            rps = exp["table"].shape[0] // 2
            np.testing.assert_array_equal(
                got["table"], exp["table"][rank * rps:(rank + 1) * rps])
            for f in ("version", "gen_nodes", "counters", "delta_bytes",
                      "clocks"):
                assert got[f] == exp[f], (f, k, got[f], exp[f])
        assert r["generations"][-1]["counters"][0] == 3


def test_reference_stream_smoke_on_the_mesh(streamed):
    """The reference's ``STREAM_SMOKE_CODE`` assertions (without its jit
    cache count) on every rank."""
    smokes = [r["smoke"] for r in streamed["ranks"]]
    lead = smokes[0]
    assert lead["status"] == ["ok"] * 16
    assert lead["snapshot"]["errors"] == 0 and \
        lead["snapshot"]["swaps_observed"] >= 1
    v0, v1, now = lead["nodes"]
    assert v1 > v0 and now == v1
    assert lead["new"].shape[0] == 1 and np.isfinite(lead["new"]).all()
    for s in smokes:
        assert s["pin_nodes"] == v0 and s["replay_equal"]
        assert s["fabric_error"] is None
        assert s["merges"] == lead["merges"] >= 1
        assert s["pending"] == 0 and s["nodes"] == lead["nodes"]
        for f in ("node_ids", "placement", "version"):
            np.testing.assert_array_equal(s["generation"][f],
                                          lead["generation"][f])
    assert smokes[1]["refused"]


def _assert_restored(got: dict, saver, merged: dict):
    """A restore of ``saver``'s checkpoint: its parameters, its delta log
    (the leader's), and its merged structure after ``merge_deltas``."""
    for a, b in zip(got["params"], _params(saver)):
        np.testing.assert_array_equal(a, b)
    want = saver.stream.state()
    if "stream" in got:
        assert got["stream"].keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got["stream"][k], want[k],
                                          err_msg=k)
        assert got["pending"] == 8
    assert got["clocks"] == (int(want["next_node"]), int(want["next_seq"]))
    for f in ("indptr", "indices", "labels"):
        np.testing.assert_array_equal(got["merged"][f], merged[f])


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_checkpoint_restores_into_the_mesh(streamed, saver):
    eng = streamed["savers"][saver]
    step = {"reference": 4, "port": 5}[saver]
    ranks = [r["restored"][saver] for r in streamed["ranks"]]
    fresh = _engines(streamed["ckpt"])[0 if saver == "reference" else 1]
    fresh.restore(streamed["root"] / saver)
    merged = _merged(fresh)
    for got in ranks:
        assert got["step"] == step
        _assert_restored(got, eng, merged)


@pytest.mark.parametrize("into", ["reference", "port"])
def test_mesh_checkpoint_restores_elsewhere(streamed, into):
    ranks = streamed["ranks"]
    paths = {r["saved_path"] for r in ranks}
    assert len(paths) == 1            # every rank returned the directory
    leader = ranks[0]["saved"]
    for r in ranks[1:]:               # one set of parameters on the mesh
        for a, b in zip(r["saved"]["params"], leader["params"]):
            np.testing.assert_array_equal(a, b)
        # a follower stages nothing; it takes the leader's clocks at the
        # merge
        assert r["saved"]["pending"] == 0
        assert r["saved_merged"]["clocks"] == \
            ranks[0]["saved_merged"]["clocks"] == leader["clocks"]
    ref, port = _engines(streamed["ckpt"])
    dst = ref if into == "reference" else port
    dst.restore(streamed["root"] / "mesh")
    assert dst.stream.state().keys() == leader["stream"].keys()
    for k, v in leader["stream"].items():
        np.testing.assert_array_equal(dst.stream.state()[k], v, err_msg=k)
    for a, b in zip(_params(dst), leader["params"]):
        np.testing.assert_array_equal(a, b)
    merged = _merged(dst)
    for r in ranks:
        for f in ("indptr", "indices", "labels"):
            np.testing.assert_array_equal(r["saved_merged"][f], merged[f])
