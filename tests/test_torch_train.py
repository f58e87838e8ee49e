"""Port parity for the training slice: the repo's AdamW, the loss and its
gradients, ``GNSEngine.fit`` / ``evaluate``, and the three repairs that
came with it (K1's gradient, K2's refusal, no CPU default).

Two training paths, each at test size (the ``tiny`` dataset, hidden 32,
fanouts (2, 3, 4), batch 32):

* ``device`` — ``SamplerConfig(backend="device")``: layer 0 is the device
  draw (the reference's jnp path, the port's plain version of K3), the
  upper layers ``aggregate_impl="reference"``;
* ``fused``  — the host backend with ``input_impl="fused"``: layer 0 is K1
  (the reference's Pallas kernel in interpret mode, with its hand-written
  VJP; the port's plain version with its autograd Function).

Tolerances: the two CPU backends sum the f32 matmuls (forward and
backward) in different orders, so losses and gradients agree to about
1e-6 relative; gradients are held to rtol 1e-4 / atol 1e-6, the loss to
rtol 1e-5.  After AdamW steps a parameter moves by lr·m/(sqrt(v)+eps),
which carries the gradient's relative error, so parameters and losses
after training are held to rtol 1e-4 / atol 1e-5.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_parity import (assert_batches_equal,  # noqa: E402
                           jax_params_to_numpy, lookup_case)
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.graph.datasets import get_dataset  # noqa: E402
from repro.kernels import ops as ops_ref  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.models import graphsage as sage_ref  # noqa: E402
from repro.optim import adam as adam_ref  # noqa: E402
from repro_torch.core import sampler as samp_port  # noqa: E402
from repro_torch.core.pipeline import EpochLoader, Prefetcher  # noqa: E402
from repro_torch.featurestore import CacheConfig as CachePort  # noqa: E402
from repro_torch.featurestore import FeatureStore  # noqa: E402
from repro_torch.gns import EngineConfig, GNSEngine  # noqa: E402
from repro_torch.kernels import ops as ops_port  # noqa: E402
from repro_torch.models import graphsage as sage_port  # noqa: E402
from repro_torch.optim import adam as adam_port  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAINED_TOL = dict(rtol=1e-4, atol=1e-5)
PATHS = {"device": dict(backend="device", input_impl="where"),
         "fused": dict(backend="host", input_impl="fused")}


@pytest.fixture(scope="module")
def ds():
    return get_dataset("tiny", seed=0)


def _cfg_json(path: str) -> str:
    """The reference's config of one training path at test size."""
    from repro.core.sampler import SamplerConfig
    from repro.featurestore import CacheConfig
    from repro.gns.config import DataConfig, ModelConfig
    p = PATHS[path]
    scfg = SamplerConfig(fanouts=(2, 3, 4), batch_size=32,
                         cache=CacheConfig(fraction=0.05),
                         backend=p["backend"])
    cfg = EngineConfigRef(
        sampler="gns", data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=scfg.cache,
        model=ModelConfig(hidden_dim=32, input_impl=p["input_impl"]), seed=0)
    return json.dumps(cfg.to_dict())


def _engines(ds, path: str):
    """The reference's engine and the port's on the CPU, built from the
    same JSON, the port starting from the reference's parameters."""
    text = _cfg_json(path)
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


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay,clip_norm,moments", [
    (0.0, None, "float32"), (0.01, None, "float32"),
    (0.01, 0.5, "float32"), (0.0, None, "bfloat16")])
def test_adamw_matches_reference(weight_decay, clip_norm, moments):
    rng = np.random.default_rng(0)
    shapes = [((6, 4), (4,)), ((8, 3), (3,))]
    tree = {"layers": [{"w": rng.normal(size=sw).astype(np.float32),
                        "b": rng.normal(size=sb).astype(np.float32)}
                       for sw, sb in shapes]}
    cfg_r = adam_ref.AdamConfig(lr=1e-2, weight_decay=weight_decay,
                                clip_norm=clip_norm,
                                moment_dtype=getattr(jnp, moments))
    cfg_p = adam_port.AdamConfig(lr=1e-2, weight_decay=weight_decay,
                                 clip_norm=clip_norm,
                                 moment_dtype=getattr(torch, moments))
    opt_r, opt_p = adam_ref.AdamW(cfg_r), adam_port.AdamW(cfg_p)
    pr = jax.tree_util.tree_map(jnp.asarray, tree)
    pp = sage_port.params_from_numpy(tree, device="cpu")
    sr, sp = opt_r.init(pr), opt_p.init(pp)
    for step in range(5):
        g = {"layers": [{k: rng.normal(size=v.shape).astype(np.float32)
                         for k, v in layer.items()}
                        for layer in tree["layers"]]}
        pr, sr = opt_r.update(jax.tree_util.tree_map(jnp.asarray, g), sr, pr)
        pp, sp = opt_p.update(sage_port.params_from_numpy(g, device="cpu"),
                              sp, pp)
    assert sp["step"] == int(sr["step"]) == 5
    _assert_params_close(pr, pp, rtol=1e-5, atol=1e-6)
    for name in ("m", "v"):
        for lr_, lp in zip(sr[name]["layers"], sp[name]["layers"]):
            for k in ("w", "b"):
                assert lp[k].dtype == getattr(torch, moments)
                np.testing.assert_allclose(
                    lp[k].float().numpy(),
                    np.asarray(lr_[k].astype(jnp.float32)),
                    rtol=1e-2 if moments == "bfloat16" else 1e-5, atol=1e-7)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"layers": [{"w": rng.normal(size=(5, 3)).astype(np.float32),
                        "b": rng.normal(size=3).astype(np.float32)}]}
    gr, nr = adam_ref.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), 0.3)
    gp, np_ = adam_port.clip_by_global_norm(
        sage_port.params_from_numpy(tree, device="cpu"), 0.3)
    np.testing.assert_allclose(float(np_), float(nr), rtol=1e-6)
    _assert_params_close(gr, gp, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
def test_loss_and_grads_match_jax(ds, path):
    ref, port = _engines(ds, path)
    rng_r, rng_p = np.random.default_rng(5), np.random.default_rng(5)
    ref.sampler.ensure_cache(rng_r)
    port.ensure_cache(rng_p)
    targets = ds.train_idx[:32]
    mb_r = ref.sampler.sample(targets, rng_r)
    mb_p = port.sampler.sample(targets, rng_p)
    assert_batches_equal(mb_r, mb_p)
    (loss_r, acc_r), grads_r = jax.value_and_grad(
        sage_ref.loss_fn, has_aux=True)(
            ref.params, mb_r.device, ref._cache_table(mb_r), ref.mcfg, None,
            ref._device_adj(mb_r))
    loss_p, acc_p, grads_p = sage_port.value_and_grad(
        port.params, mb_p.device.to("cpu"), port._cache_table(mb_p),
        port.mcfg, device_adj=port._device_adj(mb_p))
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-5)
    assert float(acc_p) == float(acc_r)
    _assert_params_close(grads_r, grads_p, **GRAD_TOL)
    assert all(t.grad is None and not t.requires_grad
               for layer in port.params["layers"] for t in layer.values())


# ---------------------------------------------------------------------------
# the engine: one step, fit, evaluate, continuing a reference run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_train_step_matches_reference(ds, path):
    ref, port = _engines(ds, path)
    rep_r = ref.fit(epochs=1, max_batches=1)
    rep_p = port.fit(epochs=1, max_batches=1)
    np.testing.assert_allclose(rep_p.losses, rep_r.losses, rtol=1e-5)
    assert port.opt_state["step"] == int(ref.opt_state["step"]) == 1
    _assert_params_close(ref.params, port.params, **TRAINED_TOL)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_fit_and_evaluate_match_reference(ds, path):
    ref, port = _engines(ds, path)
    rep_r = ref.fit(epochs=2, max_batches=3)
    rep_p = port.fit(epochs=2, max_batches=3)
    assert len(rep_p.losses) == 2 and np.isfinite(rep_p.losses).all()
    np.testing.assert_allclose(rep_p.losses, rep_r.losses, **TRAINED_TOL)
    for name in ("input_nodes_per_batch", "cached_nodes_per_batch",
                 "isolated_per_batch"):
        assert getattr(rep_p, name) == getattr(rep_r, name), name
    assert port.meter.steps == ref.meter.steps == 6
    assert port.meter.bytes_streamed == ref.meter.bytes_streamed
    assert port.store.swaps == ref.store.swaps == 2    # refreshed per epoch
    _assert_params_close(ref.params, port.params, **TRAINED_TOL)
    acc_r = ref.evaluate(num_batches=2)
    acc_p = port.evaluate(num_batches=2)
    assert acc_p == pytest.approx(acc_r, abs=1e-6)
    assert 0.0 <= acc_p <= 1.0


def test_adam_state_carries_a_reference_run_across(ds):
    ref, port = _engines(ds, "device")
    ref.fit(epochs=1, max_batches=2)
    port.fit(epochs=1, max_batches=2)      # the same sampler and cache state
    port.params = sage_port.params_from_numpy(jax_params_to_numpy(ref.params),
                                              device="cpu")
    state = jax.device_get(ref.opt_state)
    port.opt_state = adam_port.adam_state_from_numpy(state, device="cpu")
    assert port.opt_state["step"] == 2
    rep_r = ref.fit(epochs=1, max_batches=2)
    rep_p = port.fit(epochs=1, max_batches=2)
    np.testing.assert_allclose(rep_p.losses, rep_r.losses, **TRAINED_TOL)
    assert port.opt_state["step"] == int(ref.opt_state["step"]) == 4
    _assert_params_close(ref.params, port.params, **TRAINED_TOL)


def test_epoch_loader_and_prefetcher_match_reference(ds):
    from repro.core import sampler as samp_ref
    from repro.core.pipeline import EpochLoader as LoaderRef
    from repro.featurestore import CacheConfig as CacheRef
    loaders = []
    for mod, cache_cls, loader, kw in (
            (samp_ref, CacheRef, LoaderRef, {}),
            (samp_port, CachePort, EpochLoader, {"device": "cpu"})):
        cfg = mod.SamplerConfig(fanouts=(2, 3, 4), batch_size=32,
                                cache=cache_cls(fraction=0.05))
        s = mod.make_sampler("gns", ds.graph, cfg, ds.features, ds.labels,
                             train_idx=ds.train_idx, **kw)
        loaders.append(loader(s, ds.train_idx, seed=5, max_batches=2))
    for ep in (0, 1):
        got = list(Prefetcher(loaders[1].epoch(ep), depth=2))
        want = list(loaders[0].epoch(ep))
        assert len(got) == len(want) == 2
        for mb_r, mb_p in zip(want, got):
            assert_batches_equal(mb_r, mb_p)


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("miss_frac", [0.0, 0.5, 1.0])
def test_cache_lookup_agg_gradient_matches_jax(miss_frac):
    """K1 is an autograd Function whose backward is the reference's VJP in
    plain torch: the same on either device, never the plain forward's
    graph."""
    cache, streamed, slots, idx, w = lookup_case(11, 20, 80, 16, 6, 4, False,
                                                 miss_frac)

    def loss_ref(c, s, ww):
        return (kref.cache_lookup_agg_ref(c, s, jnp.asarray(slots),
                                          jnp.asarray(idx), ww) ** 2).sum()

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(cache), jnp.asarray(streamed), jnp.asarray(w))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (cache, streamed, w)]
    out = ops_port.cache_lookup_agg(leaves[0], leaves[1],
                                    torch.from_numpy(slots),
                                    torch.from_numpy(idx), leaves[2])
    assert type(out.grad_fn).__name__ == "_CacheLookupAggBackward"
    (out ** 2).sum().backward()
    for got, exp in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp),
                                   rtol=1e-5, atol=1e-5)


def test_gather_agg_refuses_a_gradient_like_jax(ds):
    """K2 has no backward in the reference (``jax.grad`` through its Pallas
    call raises); the port raises too, on either device, and points to the
    reference aggregation.  Without grad it runs."""
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(30, 8)).astype(np.float32)
    idx = rng.integers(0, 30, (5, 3)).astype(np.int32)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda f: ops_ref.gather_agg(
            f, jnp.asarray(idx), jnp.asarray(w), impl="pallas").sum())(
                jnp.asarray(feat))
    ft = torch.from_numpy(feat).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="aggregate_impl"):
        ops_port.gather_agg(ft, torch.from_numpy(idx), torch.from_numpy(w))
    with torch.no_grad():
        out = ops_port.gather_agg(ft, torch.from_numpy(idx),
                                  torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ops_ref.gather_agg(
        jnp.asarray(feat), jnp.asarray(idx), jnp.asarray(w), impl="pallas")),
        rtol=1e-5, atol=1e-6)
    cfg = EngineConfig.from_dict(json.loads(_cfg_json("fused")))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, aggregate_impl="pallas"))
    with pytest.raises(NotImplementedError, match="aggregate_impl"):
        GNSEngine(cfg, device="cpu").fit(epochs=1, max_batches=1)


def test_public_constructors_need_a_card_or_device_cpu(ds):
    """``device=None`` means the GPU everywhere: without one each public
    constructor raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    mcfg = sage_port.SageConfig(feat_dim=ds.feat_dim, hidden_dim=8,
                                num_classes=ds.num_classes)
    params = {"layers": [{"w": np.zeros((2, 2)), "b": np.zeros(2)}]}
    scfg = samp_port.SamplerConfig(fanouts=(2, 3), batch_size=8,
                                   cache=CachePort(fraction=0.05))
    calls = [
        lambda: FeatureStore(ds.features, ds.graph, CachePort()),
        lambda: samp_port.make_sampler("gns", ds.graph, scfg, ds.features,
                                       ds.labels),
        lambda: samp_port.GNSSampler(ds.graph, scfg, ds.features, ds.labels),
        lambda: sage_port.init_params(mcfg),
        lambda: sage_port.params_from_numpy(params),
        lambda: sage_port.dummy_cache_table(ds.feat_dim),
        lambda: adam_port.adam_state_from_numpy(
            {"m": params, "v": params, "step": 0}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # each takes the CPU when asked
    assert FeatureStore(ds.features, ds.graph, CachePort(),
                        device="cpu").device.type == "cpu"
    assert sage_port.dummy_cache_table(ds.feat_dim, "cpu").device.type == "cpu"
