"""``GNSServer`` over a mesh engine: one process per rank (``gloo`` ranks
spawned by ``repro_torch.launch.mesh.run_ranks``), the leader (rank 0)
takes the requests and every rank serves every batch.

The oracle is the reference WITHOUT a mesh, with as many cache shards as
the mesh has (``CacheConfig(shards=M)`` pads the table and lays its rows
out as M shards do), on the same seed, its parameters carried across:
the reference's own mesh smokes fail at the engine level on jax 0.9
(ROADMAP Queue C).  One spawn of ranks per mesh shape, (1, 2) and (2, 1),
serves for every test here:

* requests one at a time ride the same bucket and generation as the
  reference's, with logits within rtol 1e-4 / atol 1e-4;
* every rank computes every batch, pinned to the same generation, with
  the same logits bit for bit;
* a served request books once: after the requests the store's adaptive
  EMA and placement histograms equal the reference's one store, and so do
  the EMA and the generation of the refresh after them (at data 2 no
  rank replays another's requests);
* the reference's serve smoke holds on the mesh (a skewed stream, the
  hit fraction rises across serving-driven refreshes, a monotonic trail);
* a follower's ``submit`` raises ``NotLeader``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import jax_params_to_numpy  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.graph.datasets import get_dataset as get_dataset_ref  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

SPAWN_S = 300
TOL = dict(rtol=1e-4, atol=1e-4)
SIZES = (3, 8, 20, 1, 32, 5)


def _cfg_json(shards: int, smoke: bool = False) -> str:
    """The slice's config at test size in the reference's JSON: adaptive
    admission and locality placement (both fed by serving traffic), the
    fused K1 input and the K2 aggregation; ``smoke``: the reference serve
    smoke's (width 16, a refresh every 6 batches)."""
    from repro.core.sampler import SamplerConfig
    from repro.featurestore import CacheConfig
    from repro.gns.config import DataConfig, ModelConfig, ServeConfig
    cache = CacheConfig(fraction=0.05, strategy="adaptive",
                        placement="locality", shards=shards)
    scfg = SamplerConfig(fanouts=(3, 4), batch_size=32, cache=cache)
    cfg = EngineConfigRef(
        sampler="gns", data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=cache,
        model=ModelConfig(hidden_dim=16 if smoke else 32,
                          aggregate_impl="pallas", input_impl="fused"),
        serve=ServeConfig(buckets=(8, 32), max_wait_ms=2.0,
                          refresh_every=6 if smoke else None), seed=0)
    return json.dumps(cfg.to_dict())


def _store_state(store) -> dict:
    gen = store.generation
    return {"node_ids": np.asarray(gen.state.node_ids),
            "version": gen.version, "ema": store.policy._ema.copy(),
            "group_hist": {g: h.copy()
                           for g, h in store.meter.group_hist.items()}}


@pytest.fixture(scope="module", params=[(1, 2), (2, 1)],
                ids=["1x2", "2x1"])
def served(request):
    """The ranks' results on one mesh shape and the reference's."""
    data, model = request.param
    text = _cfg_json(shards=model)
    ref = EngineRef(EngineConfigRef.from_dict(json.loads(text)),
                    dataset=get_dataset_ref("tiny", seed=0))
    rng = np.random.default_rng(2)
    reqs = [rng.choice(ref.ds.graph.num_nodes, n, replace=False)
            for n in SIZES]
    spec = {"cfg": text, "params": jax_params_to_numpy(ref.params),
            "requests": reqs, "smoke_cfg": _cfg_json(model, smoke=True)}
    ranks = run_ranks("_torch_mesh_ranks:serve_ranks", data=data,
                      model=model, devices=["cpu"] * 2, backend="gloo",
                      args=(spec,), timeout_s=SPAWN_S)
    with ref.serve() as server:
        want = [server.submit(ids).result(timeout=300) for ids in reqs]
    counted = _store_state(ref.store)
    ref.store.refresh(np.random.default_rng(5), version=1)
    return {"ranks": ranks, "requests": reqs, "want": want,
            "counted": counted, "refreshed": _store_state(ref.store),
            "num_classes": ref.ds.num_classes}


def test_mesh_server_matches_reference(served):
    leader = served["ranks"][0]
    assert leader["served"] == len(SIZES)
    for (status, bucket, version, logits), r, ids in zip(
            leader["results"], served["want"], served["requests"]):
        assert status == r.status == "ok"
        assert (bucket, version) == (r.bucket, r.cache_version)
        assert logits.shape == (len(ids), served["num_classes"])
        np.testing.assert_allclose(logits, np.asarray(r.logits), **TOL)
    assert [res[1] for res in leader["results"]] == [8, 8, 32, 8, 32, 8]


def test_every_rank_serves_every_batch_alike(served):
    """One batch per request on every rank, pinned to the same generation,
    with the same logits bit for bit."""
    logs = [r["log"] for r in served["ranks"]]
    assert len(logs[0]) == len(SIZES)
    for log in logs[1:]:
        assert [v for v, _ in log] == [v for v, _ in logs[0]]
        for (_, a), (_, b) in zip(log, logs[0]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("when", ["counted", "refreshed"])
def test_a_served_request_books_once(served, when):
    """Every rank's store equals the reference's one store: the adaptive
    EMA and the placement histograms after the requests (booked under
    data-parallel group 0, once), and after a refresh that follows them
    the EMA and the drawn generation too."""
    want = served[when]
    for r in served["ranks"]:
        got = r[when]
        np.testing.assert_array_equal(got["ema"], want["ema"])
        assert sorted(got["group_hist"]) == sorted(want["group_hist"]) \
            == [0]
        np.testing.assert_array_equal(got["group_hist"][0],
                                      want["group_hist"][0])
        np.testing.assert_array_equal(got["node_ids"], want["node_ids"])
        assert got["version"] == want["version"]


def test_follower_submit_is_refused(served):
    assert all(r["refused"] for r in served["ranks"][1:])


def test_reference_serve_smoke_on_the_mesh(served):
    """The reference's ``SERVE_SMOKE_CODE`` assertions (without its jit
    cache count), on every rank's view of the same 60 requests."""
    smokes = [r["smoke"] for r in served["ranks"]]
    snap = smokes[0]["snapshot"]
    assert snap["served"] == 60 and snap["errors"] == 0, snap
    assert snap["total_p99_ms"] is not None and snap["total_p99_ms"] < 30000
    traj = smokes[0]["traj"]
    k = max(len(traj) // 4, 1)
    early, late = float(np.mean(traj[:k])), float(np.mean(traj[-k:]))
    assert smokes[0]["swaps"] >= 1, snap
    assert late > early, (early, late, traj)
    trail = smokes[0]["trail"]
    assert all(a <= b for a, b in zip(trail, trail[1:])), trail
    assert trail[-1] > trail[0], trail
    for s in smokes[1:]:
        assert s["trail"] == trail and s["versions"] == smokes[0]["versions"]
        assert s["swaps"] == smokes[0]["swaps"]
        for a, b in zip(s["logits"], smokes[0]["logits"]):
            np.testing.assert_array_equal(a, b)
        for f in ("node_ids", "version"):
            np.testing.assert_array_equal(s["generation"][f],
                                          smokes[0]["generation"][f])
