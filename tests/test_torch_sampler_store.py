"""Port parity: host samplers and the feature store.

Under the same seeds the port's GNS and NS samplers and its FeatureStore
must give the reference's LayerBlocks, cache slots, streamed rows, cache
membership, staging rows and placement, array for array.  The device table
is a torch tensor in the port and a jax array in the reference; its values
must match too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import assert_batches_equal  # noqa: E402
from repro.core import sampler as samp_ref  # noqa: E402
from repro.featurestore import CacheConfig as CacheRef  # noqa: E402
from repro.featurestore import FeatureStore as StoreRef  # noqa: E402
from repro.graph.datasets import get_dataset  # noqa: E402
from repro_torch.core import sampler as samp_port  # noqa: E402
from repro_torch.core.minibatch import block_pad_sizes  # noqa: E402
from repro_torch.featurestore import CacheConfig as CachePort  # noqa: E402
from repro_torch.featurestore import FeatureStore as StorePort  # noqa: E402


@pytest.fixture(scope="module")
def ds():
    return get_dataset("tiny", seed=0)


def _pair(ds, name, fanouts=(2, 3, 4), batch=16, **cache_kw):
    out = []
    for mod, cache_cls, kw in ((samp_ref, CacheRef, {}),
                               (samp_port, CachePort, {"device": "cpu"})):
        cfg = mod.SamplerConfig(fanouts=fanouts, batch_size=batch,
                                cache=cache_cls(fraction=0.05, **cache_kw))
        out.append(mod.make_sampler(name, ds.graph, cfg, ds.features,
                                    ds.labels, train_idx=ds.train_idx, **kw))
    return out


def _assert_generations_equal(ga, gb):
    sa, sb = ga.state, gb.state
    np.testing.assert_array_equal(sa.node_ids, sb.node_ids)
    np.testing.assert_array_equal(sa.slot_of, sb.slot_of)
    np.testing.assert_array_equal(sa.in_cache, sb.in_cache)
    np.testing.assert_array_equal(sa.probs, sb.probs)
    assert ga.lam == gb.lam and ga.version == gb.version
    np.testing.assert_array_equal(ga.staged, gb.staged)
    np.testing.assert_array_equal(np.asarray(ga.table), gb.table.numpy())
    np.testing.assert_array_equal(ga.cache_adj.indptr, gb.cache_adj.indptr)
    np.testing.assert_array_equal(ga.cache_adj.indices, gb.cache_adj.indices)


@pytest.mark.parametrize("name", ["gns", "ns"])
def test_sampler_batches_identical(ds, name):
    ref, port = _pair(ds, name)
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    ref.start_epoch(0, ra)
    port.start_epoch(0, rb)
    for _ in range(3):
        targets = ra.choice(ds.train_idx, 16, replace=False)
        assert (rb.choice(ds.train_idx, 16, replace=False) == targets).all()
        assert_batches_equal(ref.sample(targets, ra), port.sample(targets, rb))
    if name == "gns":
        _assert_generations_equal(ref.store.generation, port.store.generation)
        assert ref.store.meter.breakdown()["tiers"] == \
            port.store.meter.breakdown()["tiers"]


def test_pad_sizes_match_serving_shapes():
    """The padded block shapes per bucket b of the served paper_train
    configuration: (176b, 1056b), (16b, 176b), (b, 16b)."""
    for b in (32, 128, 512):
        assert block_pad_sizes(b, (5, 10, 15)) == samp_ref.block_pad_sizes(
            b, (5, 10, 15)) == [(176 * b, 1056 * b), (16 * b, 176 * b),
                                (b, 16 * b)]


@pytest.mark.parametrize("strategy", ["adaptive", "random_walk"])
def test_store_refreshes_identical(ds, strategy):
    """Sync and async refreshes, with policy feedback in between, draw the
    same generations in both packages."""
    ref, port = _pair(ds, "gns", strategy=strategy)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    ref.start_epoch(0, ra)
    port.start_epoch(0, rb)
    targets = ra.choice(ds.train_idx, 16, replace=False)
    rb.choice(ds.train_idx, 16, replace=False)
    ref.sample(targets, ra)
    port.sample(targets, rb)
    assert ref.store.begin_refresh(ra, version=1)
    assert port.store.begin_refresh(rb, version=1)
    assert ref.store.wait_refresh(timeout=60)
    assert port.store.wait_refresh(timeout=60)
    _assert_generations_equal(ref.store.generation, port.store.generation)
    ref.store.refresh(ra, version=2)
    port.store.refresh(rb, version=2)
    _assert_generations_equal(ref.store.generation, port.store.generation)


def test_store_locality_placement_identical(ds):
    """Two table shards and locality placement: after one batch of traffic
    from DP group 1 the solver permutes the rows the same way, and the
    device table is uploaded in the same device-row order."""
    stores = []
    for store_cls, cache_cls, kw in ((StoreRef, CacheRef, {}),
                                     (StorePort, CachePort, {"device": "cpu"})):
        cfg = cache_cls(fraction=0.05, shards=2, placement="locality")
        stores.append(store_cls(ds.features, ds.graph, cfg,
                                train_idx=ds.train_idx, dp_group=1, seed=4,
                                **kw))
    ids = np.random.default_rng(8).integers(0, ds.graph.num_nodes, 300)
    for s in stores:
        s.refresh(version=0)
        s.assemble_input(s.generation, ids, len(ids))
        s.refresh(version=1)
    ga, gb = (s.generation for s in stores)
    assert ga.state.placement is not None
    np.testing.assert_array_equal(ga.state.placement.device_row_of_slot,
                                  gb.state.placement.device_row_of_slot)
    np.testing.assert_array_equal(np.asarray(ga.table), gb.table.numpy())
    out_a = stores[0].assemble_input(ga, ids, len(ids))
    out_b = stores[1].assemble_input(gb, ids, len(ids))
    for x, y in zip(out_a, out_b):
        np.testing.assert_array_equal(x, y)


def test_table_is_a_copy_of_the_staging_half(ds):
    """``torch.from_numpy`` would alias the staging buffer a later build
    recycles: the uploaded table must not change when it is reused."""
    store = StorePort(ds.features, ds.graph, CachePort(fraction=0.05),
                      device="cpu", train_idx=ds.train_idx, seed=0)
    gen = store.refresh(version=0)
    before = gen.table.clone()
    gen.staged[:] = -7.0
    assert torch.equal(gen.table, before)
    assert store.meter.bytes_cache_upload == gen.table.numel() * 4


def test_unported_samplers_are_refused(ds):
    cfg = samp_port.SamplerConfig(fanouts=(2, 3), batch_size=8)
    for name in ("ladies", "lazygcn"):
        with pytest.raises(NotImplementedError):
            samp_port.make_sampler(name, ds.graph, cfg, ds.features,
                                   ds.labels)
    dev_cfg = samp_port.SamplerConfig(fanouts=(2, 3), batch_size=8,
                                      backend="device")
    dev = samp_port.make_sampler("gns", ds.graph, dev_cfg, ds.features,
                                 ds.labels, device="cpu")
    assert dev.backend == "device" and dev.store.build_device_adj
