"""Port parity for the whole serving slice: ``GNSEngine.infer`` and
``GNSServer`` of the port against the reference, built from the same config
JSON with the reference's parameters carried over.

Both engines run the fused K1 input layer and the K2 aggregation
(``input_impl="fused"``, ``aggregate_impl="pallas"``): the reference in
Pallas interpret mode, the port through the kernels' plain versions on the
CPU.  Host sampling is seeded identically, so the batches are the same and
the logits agree within rtol 1e-4 / atol 1e-4 (matmul summation order).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import jax_params_to_numpy  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.graph.datasets import get_dataset  # noqa: E402
from repro_torch.gns import EngineConfig, GNSEngine  # noqa: E402
from repro_torch.gns.config import MeshConfig  # noqa: E402
from repro_torch.models.graphsage import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg_json(sampler="gns") -> str:
    """The reference's config for the slice at test size, as JSON."""
    from repro.core.sampler import SamplerConfig
    from repro.featurestore import CacheConfig
    from repro.gns.config import DataConfig, ModelConfig, ServeConfig
    scfg = SamplerConfig(fanouts=(2, 3, 4), batch_size=32,
                         cache=CacheConfig(fraction=0.05))
    cfg = EngineConfigRef(
        sampler=sampler, data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=scfg.cache,
        model=ModelConfig(hidden_dim=32, aggregate_impl="pallas",
                          input_impl="fused"),
        serve=ServeConfig(buckets=(8, 32), max_wait_ms=1.0), seed=0)
    return json.dumps(cfg.to_dict())


@pytest.fixture(scope="module")
def ds():
    return get_dataset("tiny", seed=0)


@pytest.fixture(scope="module")
def engines(ds):
    text = _cfg_json()
    ref = EngineRef(EngineConfigRef.from_dict(json.loads(text)), dataset=ds)
    port = GNSEngine(EngineConfig.from_dict(json.loads(text)), device="cpu")
    port.params = params_from_numpy(jax_params_to_numpy(ref.params),
                                    device="cpu")
    return ref, port


def test_config_json_round_trips_across_packages():
    for name in ("paper_train", "quickstart", "stream_replay"):
        d = EngineConfigRef.preset(name).to_dict()
        port = EngineConfig.from_dict(json.loads(json.dumps(d)))
        assert port.to_dict() == d
        assert EngineConfigRef.from_dict(
            json.loads(json.dumps(port.to_dict()))) == EngineConfigRef.preset(
                name)
    d = json.loads(_cfg_json())
    d["optim"]["moment_dtype"] = "bfloat16"
    assert EngineConfig.from_dict(d).optim.moment_dtype == torch.bfloat16
    assert json.loads(json.dumps(EngineConfig.from_dict(d).to_dict())) == d


def test_infer_matches_reference(engines, ds):
    ref, port = engines
    ids = np.random.default_rng(1).choice(ds.graph.num_nodes, 45,
                                          replace=False)
    want = ref.infer(ids)
    got = port.infer(ids)
    assert got.shape == want.shape == (45, ds.num_classes)
    np.testing.assert_allclose(got, want, **TOL)
    gr, gp = ref.store.generation, port.store.generation
    np.testing.assert_array_equal(gr.state.node_ids, gp.state.node_ids)
    np.testing.assert_array_equal(np.asarray(gr.table), gp.table.numpy())


def test_server_matches_reference(engines, ds):
    """Requests submitted one at a time ride identical micro-batches in
    both servers (same seeds, same buckets), so every result agrees."""
    ref, port = engines
    rng = np.random.default_rng(2)
    reqs = [rng.choice(ds.graph.num_nodes, n, replace=False)
            for n in (3, 8, 20, 1, 32)]
    results = []
    for eng in (ref, port):
        out = []
        with eng.serve() as server:
            for ids in reqs:
                out.append(server.submit(ids).result(timeout=300))
        results.append(out)
        assert server.meter.snapshot()["served"] == len(reqs)
    for r, p, ids in zip(*results, reqs):
        assert r.status == p.status == "ok"
        assert (r.bucket, r.cache_version) == (p.bucket, p.cache_version)
        assert p.logits.shape == (len(ids), ds.num_classes)
        np.testing.assert_allclose(p.logits, r.logits, **TOL)
    assert [p.bucket for p in results[1]] == [8, 8, 32, 8, 32]


def test_ns_engine_serves_without_a_store(ds):
    port = GNSEngine(EngineConfig.from_dict(json.loads(_cfg_json("ns"))),
                     device="cpu")
    assert port.store is None
    out = port.infer(np.arange(10))
    assert out.shape == (10, ds.num_classes) and np.isfinite(out).all()


def test_engine_refuses_to_run_silently_on_the_cpu():
    """Without ``device=`` the engine runs on the GPU, or raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = EngineConfig.from_dict(json.loads(_cfg_json()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNSEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNSEngine(cfg, device="cuda")


def test_engine_mesh_raises_without_a_process_group():
    """A mesh of several ranks runs one engine per rank over the caller's
    process group; with none the engine raises before building anything."""
    import dataclasses
    cfg = EngineConfig.from_dict(json.loads(_cfg_json()))
    with pytest.raises(RuntimeError, match="process group"):
        GNSEngine(dataclasses.replace(cfg, mesh=MeshConfig(data=2)),
                  device="cpu")


def test_engine_mesh_raises_on_a_world_size_mismatch():
    """The process group must have exactly data·model ranks."""
    import dataclasses
    from _torch_parity import one_rank_group
    cfg = EngineConfig.from_dict(json.loads(_cfg_json()))
    with one_rank_group():
        for mesh in (MeshConfig(data=2), MeshConfig(model=2),
                     MeshConfig(data=2, model=2)):
            with pytest.raises(ValueError, match="ranks"):
                GNSEngine(dataclasses.replace(cfg, mesh=mesh), device="cpu")


def test_engine_builds_the_stream_replay_preset():
    """Streaming ingest is ported: preset ``stream_replay`` builds on the
    CPU with its delta buffer attached, as the reference wires it in its
    constructor."""
    cfg = EngineConfig.preset("stream_replay")
    assert cfg.stream is not None
    eng = GNSEngine(cfg, device="cpu")
    rec = eng.describe()["stream"]
    assert rec["enabled"] and rec["pending_deltas"] == 0
    assert rec["max_pending"] == cfg.stream.max_pending
    assert eng.store.n_shards == 2 and eng.store.stream_cfg == cfg.stream

