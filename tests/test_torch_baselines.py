"""Port parity for the paper's baselines and the rest of the training
surface: the LADIES and LazyGCN samplers, the estimator-variance probes,
the LR schedules (and AdamW under one), ``GNSEngine.fit`` with each
baseline on the fused K1 input, ``describe`` and its diff mode, and the
``GNNTrainer`` shim.

Sizes: the ``tiny`` dataset (2,000 nodes, 32 features), batch 32.  The
samplers are host numpy in both packages, so their blocks are held bit for
bit under the same ``np.random.Generator`` seeds, and so is
``estimator_mse`` (float64 numpy on both sides; rtol 1e-12).  The
schedules compute in float32 on both sides (numpy's and XLA's cosine may
differ in the last bit: rtol 1e-6, atol 1e-7).  Training holds losses and
parameters to ``TRAINED_TOL`` and AdamW to ``test_adamw_matches_reference``'s
tolerances, for the reasons ``tests/test_torch_train.py`` gives.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_parity import (assert_batches_equal,  # noqa: E402
                           jax_params_to_numpy)
from repro.core import sampler as samp_ref  # noqa: E402
from repro.core import variance as var_ref  # noqa: E402
from repro.core.pipeline import EpochLoader as LoaderRef  # noqa: E402
from repro.core.pipeline import Prefetcher as PrefetcherRef  # noqa: E402
from repro.featurestore import CacheConfig as CacheRef  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.graph.datasets import get_dataset  # noqa: E402
from repro.optim import adam as adam_ref  # noqa: E402
from repro.optim import schedules as sched_ref  # noqa: E402
from repro_torch.core import sampler as samp_port  # noqa: E402
from repro_torch.core import variance as var_port  # noqa: E402
from repro_torch.core.pipeline import EpochLoader, Prefetcher  # noqa: E402
from repro_torch.featurestore import CacheConfig as CachePort  # noqa: E402
from repro_torch.gns import EngineConfig, GNSEngine  # noqa: E402
from repro_torch.gns import describe as describe_port  # noqa: E402
from repro_torch.models import graphsage as sage_port  # noqa: E402
from repro_torch.optim import adam as adam_port  # noqa: E402
from repro_torch.optim import schedules as sched_port  # noqa: E402
from repro_torch.train import GNNTrainer  # noqa: E402

TRAINED_TOL = dict(rtol=1e-4, atol=1e-5)
# small LADIES layers and lane cap, so isolated rows and the lane-cap
# subsample both occur at batch 32; LazyGCN periods of 2, 3 and 4 batches
BASELINE_KW = {"ladies": dict(layer_size=16, lane_cap=8),
               "lazygcn": dict(recycle_period=2, recycle_growth=1.5)}


@pytest.fixture(scope="module")
def ds():
    return get_dataset("tiny", seed=0)


def _pair(ds, name, fanouts=(3, 4, 5), batch=32, **kw):
    """The reference's sampler and the port's, from the same config."""
    out = []
    for mod, cache_cls in ((samp_ref, CacheRef), (samp_port, CachePort)):
        cfg = mod.SamplerConfig(fanouts=fanouts, batch_size=batch,
                                cache=cache_cls(fraction=0.05, period=1),
                                **kw)
        out.append(mod.make_sampler(name, ds.graph, cfg, ds.features,
                                    ds.labels))
    return out


def _port_sampler(ds, name, **kw):
    """``tests/test_sampler.py``'s ``_mk`` on the port."""
    cfg = samp_port.SamplerConfig(fanouts=kw.pop("fanouts", (3, 4, 5)),
                                  batch_size=kw.pop("batch_size", 32),
                                  cache=CachePort(fraction=0.05, period=1),
                                  **kw)
    s = samp_port.make_sampler(name, ds.graph, cfg, ds.features, ds.labels,
                               train_idx=ds.train_idx, device="cpu")
    s.start_epoch(0, np.random.default_rng(0))
    return s


def _targets(ds, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.choice(ds.train_idx, size=n, replace=False)


# ---------------------------------------------------------------------------
# the samplers: bitwise batches under the same seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BASELINE_KW))
def test_baseline_batches_identical(ds, name):
    """Six batches in a row: LADIES's Gumbel top-s draw, lane-cap
    subsample and row renormalisation; LazyGCN's fresh and recycled
    batches (``bytes_streamed`` 0), with ``num_isolated`` and the byte
    counts."""
    ref, port = _pair(ds, name, **BASELINE_KW[name])
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    ref.start_epoch(0, ra)
    port.start_epoch(0, rb)
    got = []
    for i in range(6):
        t = ds.train_idx[i * 32:(i + 1) * 32]
        mb_r, mb_p = ref.sample(t, ra), port.sample(t, rb)
        assert_batches_equal(mb_r, mb_p)
        got.append(mb_p)
    assert ra.random() == rb.random()          # the same draws consumed
    assert ref.pad_sizes == port.pad_sizes
    if name == "ladies":
        assert any(mb.num_isolated for mb in got)
        assert all(mb.device.blocks[0].nbr_idx.shape[1] == 8 for mb in got)
    else:                # periods of round(2 * 1.5^p) batches: 2, 3, 4
        assert [mb.bytes_streamed == 0 for mb in got] == [
            False, True, False, True, True, False]


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("name", sorted(BASELINE_KW))
def test_baseline_loader_identical(ds, name, prefetch):
    """Through the epoch loader, two epochs of three batches, with the
    ``Prefetcher`` thread on both sides or on neither (LazyGCN keeps state
    across ``sample`` calls, and with prefetch it is sampled on the
    thread)."""
    ref, port = _pair(ds, name, **BASELINE_KW[name])
    lr_ = LoaderRef(ref, ds.train_idx, seed=5, max_batches=3)
    lp = EpochLoader(port, ds.train_idx, seed=5, max_batches=3)
    for ep in (0, 1):
        it_r, it_p = lr_.epoch(ep), lp.epoch(ep)
        if prefetch:
            it_r, it_p = PrefetcherRef(it_r, depth=2), Prefetcher(it_p,
                                                                  depth=2)
        want, got = list(it_r), list(it_p)
        assert len(want) == len(got) == 3
        for mb_r, mb_p in zip(want, got):
            assert_batches_equal(mb_r, mb_p)


def test_ladies_isolated_counted(ds):
    s = _port_sampler(ds, "ladies", layer_size=8)   # tiny layer -> isolated
    mb = s.sample(_targets(ds, 32), np.random.default_rng(6))
    assert mb.num_isolated >= 0
    in_blk = mb.device.blocks[0]
    rows = in_blk.dst_mask > 0
    isolated = (np.abs(in_blk.nbr_w[rows]).sum(axis=1) == 0).sum()
    assert mb.num_isolated == isolated


def test_ladies_layer_size_bounds_new_nodes(ds):
    s = _port_sampler(ds, "ladies", layer_size=16)
    mb = s.sample(_targets(ds, 32), np.random.default_rng(7))
    # each layer adds at most layer_size new nodes over the previous
    # (src = dst ++ sampled), so input node count <= batch + L*layer_size
    assert mb.num_input <= 32 + 3 * 16


def test_ladies_rows_renormalised(ds):
    """The LADIES P̃: every row with a sampled neighbor sums to 1 over at
    most ``lane_cap`` live lanes; masked lanes carry weight 0."""
    s = _port_sampler(ds, "ladies", layer_size=64, lane_cap=4)
    mb = s.sample(_targets(ds, 32), np.random.default_rng(9))
    for blk in mb.device.blocks:
        sums = blk.nbr_w.sum(axis=1)
        live = sums > 0
        np.testing.assert_allclose(sums[live], 1.0, rtol=1e-6)
        assert blk.nbr_idx.shape[1] == 4
        assert (blk.nbr_w >= 0).all()


def test_lazygcn_recycles(ds):
    s = _port_sampler(ds, "lazygcn", recycle_period=3, recycle_growth=1.0)
    rng = np.random.default_rng(8)
    t = _targets(ds, 32)
    mbs = [s.sample(t, rng) for _ in range(3)]
    # identical recycled structure within a period
    b0 = mbs[0].device.blocks[0].nbr_idx
    assert np.array_equal(b0, mbs[1].device.blocks[0].nbr_idx)
    assert np.array_equal(b0, mbs[2].device.blocks[0].nbr_idx)
    # recycled steps stream zero fresh bytes
    assert mbs[1].bytes_streamed == 0 and mbs[2].bytes_streamed == 0
    # fresh sample next period
    mb3 = s.sample(t, rng)
    assert not np.array_equal(b0, mb3.device.blocks[0].nbr_idx)


def test_lazygcn_start_epoch_drops_the_megabatch(ds):
    s = _port_sampler(ds, "lazygcn", recycle_period=4, recycle_growth=1.0)
    rng = np.random.default_rng(3)
    t = _targets(ds, 32)
    first = s.sample(t, rng)
    assert s.sample(t, rng).bytes_streamed == 0
    s.start_epoch(1, rng)
    assert s.sample(t, rng).bytes_streamed > 0 < first.bytes_streamed
    assert s.pad_sizes == s.inner.pad_sizes


# ---------------------------------------------------------------------------
# estimator variance (§3.5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ns", "gns"])
def test_estimator_mse_matches_reference(ds, name):
    h = ds.features.astype(np.float64)
    nodes = ds.train_idx[:48]
    kw = dict(sampler_name=name, fanout=4, cache_fraction=0.1, trials=10,
              seed=2, labels=ds.labels)
    want = var_ref.estimator_mse(ds.graph, h, nodes, **kw)
    got = var_port.estimator_mse(ds.graph, h, nodes, device="cpu", **kw)
    assert got == pytest.approx(want, rel=1e-12)
    assert got > 0
    np.testing.assert_array_equal(
        var_port.full_neighbor_mean(ds.graph, h, nodes),
        var_ref.full_neighbor_mean(ds.graph, h, nodes))


def test_estimator_mse_gns_needs_a_card_or_device_cpu(ds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        var_port.estimator_mse(ds.graph, ds.features, ds.train_idx[:8],
                               "gns", 2, 0.1, trials=1)


# ---------------------------------------------------------------------------
# LR schedules and AdamW under one
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": lambda m: m.constant(),
    "warmup_cosine": lambda m: m.warmup_cosine(5, 40),
    "warmup_cosine_min0": lambda m: m.warmup_cosine(10, 30, min_frac=0.0),
    "warmup_cosine_nowarm": lambda m: m.warmup_cosine(0, 1, min_frac=0.3),
    "inverse_sqrt": lambda m: m.inverse_sqrt(7),
    "inverse_sqrt_nowarm": lambda m: m.inverse_sqrt(0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    fr, fp = SCHEDULES[name](sched_ref), SCHEDULES[name](sched_port)
    want = np.array([np.asarray(fr(jnp.int32(s))) for s in range(51)])
    got = np.array([fp(s) for s in range(51)])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_with_warmup_cosine_matches_reference(weight_decay):
    """``lr_schedule(step) * lr`` at the step being made, as the
    reference's ``update`` takes it (``src/repro/optim/adam.py:64``)."""
    rng = np.random.default_rng(0)
    shapes = [((6, 4), (4,)), ((8, 3), (3,))]
    tree = {"layers": [{"w": rng.normal(size=sw).astype(np.float32),
                        "b": rng.normal(size=sb).astype(np.float32)}
                       for sw, sb in shapes]}
    cfg_r = adam_ref.AdamConfig(lr=1e-2, weight_decay=weight_decay)
    cfg_p = adam_port.AdamConfig(lr=1e-2, weight_decay=weight_decay)
    opt_r = adam_ref.AdamW(cfg_r, lr_schedule=sched_ref.warmup_cosine(2, 5))
    opt_p = adam_port.AdamW(cfg_p, lr_schedule=sched_port.warmup_cosine(2, 5))
    pr = jax.tree_util.tree_map(jnp.asarray, tree)
    pp = sage_port.params_from_numpy(tree, device="cpu")
    sr, sp = opt_r.init(pr), opt_p.init(pp)
    for _ in range(5):
        g = {"layers": [{k: rng.normal(size=v.shape).astype(np.float32)
                         for k, v in layer.items()}
                        for layer in tree["layers"]]}
        pr, sr = opt_r.update(jax.tree_util.tree_map(jnp.asarray, g), sr, pr)
        pp, sp = opt_p.update(sage_port.params_from_numpy(g, device="cpu"),
                              sp, pp)
    assert sp["step"] == int(sr["step"]) == 5
    want = jax_params_to_numpy(pr)
    for lr_, lp in zip(want["layers"], pp["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(lp[k].numpy(), lr_[k], rtol=1e-5,
                                       atol=1e-6)
    for name in ("m", "v"):
        for lr_, lp in zip(sr[name]["layers"], sp[name]["layers"]):
            for k in ("w", "b"):
                np.testing.assert_allclose(lp[k].numpy(), np.asarray(lr_[k]),
                                           rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the engine: each baseline trains through the fused K1 input
# ---------------------------------------------------------------------------

def _cfg_json(name: str, input_impl: str = "fused", prefetch=False) -> str:
    from repro.core.sampler import SamplerConfig
    from repro.gns.config import DataConfig, ModelConfig
    scfg = SamplerConfig(fanouts=(2, 3, 4), batch_size=32,
                         cache=CacheRef(fraction=0.05),
                         **BASELINE_KW.get(name, {}))
    cfg = EngineConfigRef(
        sampler=name, data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=scfg.cache,
        model=ModelConfig(hidden_dim=32, input_impl=input_impl), seed=0,
        prefetch=prefetch)
    return json.dumps(cfg.to_dict())


def _engines(ds, name: str, **kw):
    text = _cfg_json(name, **kw)
    ref = EngineRef(EngineConfigRef.from_dict(json.loads(text)), dataset=ds)
    port = GNSEngine(EngineConfig.from_dict(json.loads(text)), device="cpu")
    port.params = sage_port.params_from_numpy(jax_params_to_numpy(ref.params),
                                              device="cpu")
    return ref, port


def _assert_params_close(ref_params, port_params, **tol):
    want = jax_params_to_numpy(ref_params)
    for lr_, lp in zip(want["layers"], port_params["layers"]):
        for name in ("w", "b"):
            np.testing.assert_allclose(lp[name].numpy(), lr_[name], **tol,
                                       err_msg=name)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("name", sorted(BASELINE_KW))
def test_baseline_fit_matches_reference(ds, name, prefetch):
    ref, port = _engines(ds, name, prefetch=prefetch)
    assert port.mcfg.input_impl == "fused" and port.store is None
    rep_r = ref.fit(epochs=2, max_batches=3)
    rep_p = port.fit(epochs=2, max_batches=3)
    assert len(rep_p.losses) == 2 and np.isfinite(rep_p.losses).all()
    np.testing.assert_allclose(rep_p.losses, rep_r.losses, **TRAINED_TOL)
    for field in ("input_nodes_per_batch", "cached_nodes_per_batch",
                  "isolated_per_batch"):
        assert getattr(rep_p, field) == getattr(rep_r, field), field
    assert port.meter.steps == ref.meter.steps == 6
    assert port.meter.bytes_streamed == ref.meter.bytes_streamed
    _assert_params_close(ref.params, port.params, **TRAINED_TOL)
    assert port.opt_state["step"] == int(ref.opt_state["step"]) == 6
    assert port.evaluate(num_batches=2) == pytest.approx(
        ref.evaluate(num_batches=2), abs=1e-6)


def test_model_cfg_overrides_the_declarative_model(ds):
    cfg = EngineConfig.from_dict(json.loads(_cfg_json("ns")))
    mcfg = sage_port.SageConfig(feat_dim=ds.feat_dim, hidden_dim=12,
                                num_classes=ds.num_classes, num_layers=3,
                                input_impl="fused")
    eng = GNSEngine(cfg, device="cpu", dataset=ds, model_cfg=mcfg)
    assert eng.mcfg is mcfg
    assert eng.params["layers"][0]["w"].shape == (2 * ds.feat_dim, 12)
    assert np.isfinite(eng.fit(1, max_batches=2).losses).all()


# ---------------------------------------------------------------------------
# describe and its diff mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,backend", [("gns", "host"), ("gns", "device"),
                                          ("ns", "host"), ("ladies", "host"),
                                          ("lazygcn", "host")])
def test_describe_matches_reference(ds, name, backend):
    text = json.loads(_cfg_json(name, input_impl="where"))
    text["sampling"]["backend"] = backend
    ref = EngineRef(EngineConfigRef.from_dict(text), dataset=ds)
    port = GNSEngine(EngineConfig.from_dict(text), device="cpu", dataset=ds)
    ref.fit(1, max_batches=1)
    port.fit(1, max_batches=1)
    rr, rp = ref.describe(), port.describe()
    assert rr.keys() == rp.keys()
    assert rr["meter"].keys() == rp["meter"].keys()
    for k in rr:
        if k != "meter":
            assert rp[k] == rr[k], k
    assert rp["sampler_backend"] == backend and rp["mesh"] is None
    assert rp["meter"]["steps"] == 1


def test_padded_rows_matches_reference():
    from repro.featurestore import FeatureStore as StoreRef
    from repro_torch.featurestore import FeatureStore as StorePort
    for n, frac, mult in ((2000, 0.05, 1), (30500, 0.01, 4), (7, 0.5, 3)):
        assert StorePort.padded_rows(n, frac, multiple=mult) == \
            StoreRef.padded_rows(n, frac, multiple=mult)


def test_describe_diff_mode(ds):
    """``tests/test_engine.py``'s diff test on the port: identical configs
    diff as same (volatile keys excluded); a cache-fraction change shows up
    in both the config layer and the record layer."""
    a = EngineConfig.from_dict(json.loads(_cfg_json("gns", "where")))
    b = dataclasses.replace(a, cache=CachePort(fraction=0.2, period=1))
    same = describe_port.diff(a, a, dataset_a=ds, dataset_b=ds, device="cpu")
    assert same["same"] and same["record"]["same"], same
    d = describe_port.diff(a, b, dataset_a=ds, dataset_b=ds, device="cpu")
    assert not d["same"]
    assert "cache.fraction" in d["config"]["changed"]
    assert "cache_rows" in d["record"]["changed"]
    r = describe_port.diff_records({"x": 1, "both": 2}, {"y": 3, "both": 2})
    assert r["only_a"] == {"x": 1} and r["only_b"] == {"y": 3}
    assert not r["changed"] and not r["same"]
    from repro.gns.describe import diff_records as diff_records_ref
    rec = {"a": {"b": 1, "meter": {"t": 2}}, "compile_s": 3.0, "c": [1]}
    rec2 = {"a": {"b": 2, "meter": {"t": 5}}, "compile_s": 9.0, "c": [1]}
    assert describe_port.diff_records(rec, rec2) == diff_records_ref(rec,
                                                                     rec2)


# ---------------------------------------------------------------------------
# the GNNTrainer shim
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """Torch on one CPU thread: with several, the backward's scatter-adds
    and the matmuls split their sums by thread, so two runs of the same
    engine differ in the last bits (up to 1.5e-8 at this size)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["gns", "ladies"])
def test_trainer_shim_bitwise_parity(ds, name, one_thread):
    scfg = samp_port.SamplerConfig(fanouts=(3, 4), batch_size=32,
                                   cache=CachePort(fraction=0.1, period=1),
                                   **BASELINE_KW.get(name, {}))
    eng = GNSEngine(EngineConfig(sampler=name, sampling=scfg,
                                 cache=scfg.cache, seed=0),
                    device="cpu", dataset=ds)
    rep_e = eng.fit(2, max_batches=4)

    tr = GNNTrainer(ds, name, sampler_cfg=scfg, seed=0, device="cpu")
    rep_t = tr.train(2, max_batches=4)

    assert rep_t.losses == rep_e.losses
    for la, lb in zip(eng.params["layers"], tr.params["layers"]):
        for k in ("w", "b"):
            assert torch.equal(la[k], lb[k])
    for m in ("m", "v"):
        for la, lb in zip(eng.opt_state[m]["layers"],
                          tr.opt_state[m]["layers"]):
            for k in ("w", "b"):
                assert torch.equal(la[k], lb[k])
    assert tr.opt_state["step"] == eng.opt_state["step"] == 8
    # the shim's state aliases the engine's (same run, not a copy)
    assert tr.meter is tr.engine.meter
    assert tr.store is tr.engine.store
    assert tr.sampler is tr.engine.sampler
    tr.params = eng.params
    assert tr.engine.params is eng.params
    assert 0.0 <= tr.evaluate(ds.val_idx, num_batches=1) <= 1.0


def test_trainer_refuses_a_mesh(ds):
    for kw in ({"mesh": object()}, {"cache_shard_axis": "model"}):
        with pytest.raises(NotImplementedError, match="one device"):
            GNNTrainer(ds, "ns", device="cpu", **kw)
