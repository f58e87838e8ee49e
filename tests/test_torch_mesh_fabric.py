"""``ServeFabric`` over a (2, 2) mesh engine: four ``gloo`` ranks spawned
once by ``repro_torch.launch.mesh.run_ranks`` for every test here.  The
leader (rank 0) runs the front end (tenancy, routing, schedulers, the
watchdog's decisions); worker ``w`` runs on every rank, on process groups
of its own.

* Requests pinned to a worker and sent one at a time match the
  reference's fabric WITHOUT a mesh and with 2 cache shards (the layout
  of the mesh's 2 shards; the reference's own mesh smokes fail on jax 0.9,
  ROADMAP Queue C): the same bucket and generation, logits within rtol
  1e-4 / atol 1e-4.
* Under two concurrent workers and a refresh every 2 batches, every rank
  runs each worker's batches pinned to the same generations with the same
  logits bit for bit, and ends on the same generation.
* The reference's fabric smoke holds: both tenants served, most owned ids
  routed to their owner, a killed worker fails over losslessly (it dies
  on every rank).
* A follower's ``submit`` raises ``NotLeader``.

``transport="tcp"`` on a mesh config (a one-process coordinator over
endpoints that are worlds of ranks) is ``tests/test_torch_mesh_rpc.py``'s.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import jax_params_to_numpy  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import FabricConfig as FabricConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.graph.datasets import get_dataset as get_dataset_ref  # noqa: E402
from repro.serve import ServeFabric as ServeFabricRef  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

SPAWN_S = 300
TOL = dict(rtol=1e-4, atol=1e-4)
PINNED = [(0, 5), (1, 3), (0, 12), (1, 20), (1, 7)]     # (worker, ids)


def _cfg_json(shards: int, adaptive: bool = False, width: int = 32,
              refresh_every=None, fraction: float = 0.1) -> str:
    from repro.core.sampler import SamplerConfig
    from repro.featurestore import CacheConfig
    from repro.gns.config import DataConfig, ModelConfig, ServeConfig
    extra = ({"strategy": "adaptive", "placement": "locality"} if adaptive
             else {})
    cache = CacheConfig(fraction=fraction, shards=shards, **extra)
    scfg = SamplerConfig(fanouts=(3, 4), batch_size=32, cache=cache)
    cfg = EngineConfigRef(
        sampler="gns", data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=cache,
        model=ModelConfig(hidden_dim=width, aggregate_impl="pallas",
                          input_impl="fused"),
        serve=ServeConfig(buckets=(8, 32), max_wait_ms=2.0,
                          refresh_every=refresh_every), seed=3)
    return json.dumps(cfg.to_dict())


@pytest.fixture(scope="module")
def fabric():
    text = _cfg_json(shards=2)
    ref = EngineRef(EngineConfigRef.from_dict(json.loads(text)),
                    dataset=get_dataset_ref("tiny", seed=0))
    rng = np.random.default_rng(4)
    pinned = [(w, rng.choice(ref.ds.graph.num_nodes, n, replace=False))
              for w, n in PINNED]
    spec = {"cfg": text, "params": jax_params_to_numpy(ref.params),
            "pinned": pinned,
            "refresh_cfg": _cfg_json(2, adaptive=True, refresh_every=2),
            "smoke_cfg": _cfg_json(2, adaptive=True, width=16,
                                   fraction=0.05)}
    ranks = run_ranks("_torch_mesh_ranks:fabric_ranks", data=2, model=2,
                      devices=["cpu"] * 4, backend="gloo", args=(spec,),
                      timeout_s=SPAWN_S)
    fab = ServeFabricRef(ref, cfg=FabricConfigRef(
        workers=2, stall_timeout_ms=600_000.0))
    with fab:
        want = [fab.submit(ids, worker=w).result(timeout=600)
                for w, ids in pinned]
    return {"ranks": ranks, "pinned": pinned, "want": want,
            "num_classes": ref.ds.num_classes}


def _assert_logs_equal(logs):
    """Each worker's batches, in its order, on every rank: the same pinned
    generations and logits bit for bit."""
    for log in logs[1:]:
        assert sorted(log) == sorted(logs[0])
        for name, batches in logs[0].items():
            assert [v for v, _ in log[name]] == [v for v, _ in batches]
            for (_, a), (_, b) in zip(log[name], batches):
                np.testing.assert_array_equal(a, b)


def test_pinned_requests_match_reference_fabric(fabric):
    leader = fabric["ranks"][0]
    assert leader["pinned_errors"] == (0, None)
    for (status, bucket, version, logits), r, (_, ids) in zip(
            leader["pinned"], fabric["want"], fabric["pinned"]):
        assert status == r.status == "ok"
        assert (bucket, version) == (r.bucket, r.cache_version)
        assert logits.shape == (len(ids), fabric["num_classes"])
        np.testing.assert_allclose(logits, np.asarray(r.logits), **TOL)
    logs = [r["pinned_log"] for r in fabric["ranks"]]
    assert {k: len(v) for k, v in logs[0].items()} == {
        "gns-fabric-0": 2, "gns-fabric-1": 3}
    _assert_logs_equal(logs)


def test_every_rank_holds_one_generation_under_two_workers(fabric):
    """Two workers sample concurrently while the watchdog swaps in a
    refresh every 2 batches: every batch runs against the same generation
    on every rank, and every rank ends on the same generation."""
    ranks = fabric["ranks"]
    leader = ranks[0]
    assert leader["refresh_status"] == ["ok"] * 48
    snap = leader["refresh_snapshot"]
    assert snap["errors"] == 0 and snap["swaps_observed"] >= 2
    logs = [r["refresh_log"] for r in ranks]
    _assert_logs_equal(logs)
    versions = {v for batches in logs[0].values() for v, _ in batches}
    assert len(versions) >= 2, versions       # batches on both sides of a swap
    assert all(r["refresh_errors"] is None for r in ranks)
    want = leader["refresh_generation"]
    assert want["version"] >= 2
    for r in ranks[1:]:
        got = r["refresh_generation"]
        assert got["version"] == want["version"]
        for f in ("node_ids", "placement"):
            np.testing.assert_array_equal(got[f], want[f])
    for m in (0, 1):      # the ranks of one shard hold the same rows
        np.testing.assert_array_equal(ranks[m]["refresh_generation"]["table"],
                                      ranks[m + 2]["refresh_generation"]
                                      ["table"])


def test_a_swap_waits_for_the_batches_sampled_before_it(fabric):
    """Worker 0 samples a batch against generation 0, then stalls before
    the other ranks hear of it while the watchdog swaps generation 1 in:
    every rank publishes only after sampling that batch, so it runs
    against generation 0 on every rank, bit for bit."""
    ranks = fabric["ranks"]
    st = ranks[0]["stall"]
    assert (st["first"], st["stalled"]) == (0, 0)
    assert st["swaps"] >= 1 and st["live"] >= 1      # swapped mid-batch
    _assert_logs_equal([r["stall_log"] for r in ranks])
    assert all(r["stall_errors"] is None for r in ranks)


def test_reference_fabric_smoke_on_the_mesh(fabric):
    """The reference's ``FABRIC_SMOKE_CODE`` assertions at (2, 2)."""
    leader = fabric["ranks"][0]
    assert leader["smoke_status"] == ["ok"] * 67
    assert leader["smoke_healthy"] == [1]
    snap = leader["smoke_snapshot"]
    for t in ("mobile", "batch"):
        assert snap["tenants"][t]["rejected"] == 0, snap["tenants"]
    assert snap["tenants"]["mobile"]["served"] >= 31
    assert snap["tenants"]["batch"]["served"] >= 36
    rt = snap["routing"]
    assert rt["routed_known_ids"] > 0, rt
    assert rt["route_local_fraction"] > 0.5, rt
    assert set(rt["worker_batches"]) == {0, 1}, rt
    assert rt["failovers"] >= 1 and rt["retries"] >= 1, rt
    assert snap["errors"] == 0, snap
    assert snap["total_p99_ms"] is not None and snap["total_p99_ms"] < 60000
    # the killed worker died on every rank; the other stopped with the
    # leader's stop
    assert all(r["smoke_alive"] == [False, False] for r in fabric["ranks"])


def test_follower_submit_is_refused(fabric):
    assert all(r["refused"] for r in fabric["ranks"][1:])

