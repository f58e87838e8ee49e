"""Port parity: the GraphSAGE forward.

The same sampled batch, the same cache table and the reference's own
initial parameters (carried over with ``params_from_numpy``) must give the
reference's logits, for every input/aggregation implementation the port
shares with it.  Tolerance rtol 1e-5 / atol 1e-5: the two CPU backends sum
the concat-matmul in different orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_parity import assert_batches_equal, jax_params_to_numpy  # noqa: E402
from repro.core import sampler as samp_ref  # noqa: E402
from repro.featurestore import CacheConfig as CacheRef  # noqa: E402
from repro.graph.datasets import get_dataset  # noqa: E402
from repro.models import graphsage as sage_ref  # noqa: E402
from repro_torch.core import sampler as samp_port  # noqa: E402
from repro_torch.featurestore import CacheConfig as CachePort  # noqa: E402
from repro_torch.models import graphsage as sage_port  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ds():
    return get_dataset("tiny", seed=0)


def _batches(ds, name):
    out = []
    for mod, cache_cls in ((samp_ref, CacheRef), (samp_port, CachePort)):
        cfg = mod.SamplerConfig(fanouts=(2, 3, 4), batch_size=16,
                                cache=cache_cls(fraction=0.05))
        s = mod.make_sampler(name, ds.graph, cfg, ds.features, ds.labels,
                             train_idx=ds.train_idx)
        rng = np.random.default_rng(0)
        s.start_epoch(0, rng)
        targets = rng.choice(ds.train_idx, 16, replace=False)
        out.append(s.sample(targets, rng))
    assert_batches_equal(*out)
    return out


@pytest.mark.parametrize("sampler", ["gns", "ns"])
@pytest.mark.parametrize("aggregate_impl,input_impl", [
    ("reference", "where"), ("pallas", "where"), ("pallas", "fused")])
def test_forward_matches_reference(ds, sampler, aggregate_impl, input_impl):
    mb_ref, mb_port = _batches(ds, sampler)
    cfg_ref = sage_ref.SageConfig(feat_dim=ds.feat_dim, hidden_dim=32,
                                  num_classes=ds.num_classes,
                                  aggregate_impl=aggregate_impl,
                                  input_impl=input_impl)
    params = sage_ref.init_params(jax.random.PRNGKey(0), cfg_ref)
    if mb_ref.cache_gen is not None:
        table_ref, table_port = mb_ref.cache_gen.table, mb_port.cache_gen.table
    else:
        table_ref = sage_ref.dummy_cache_table(ds.feat_dim)
        table_port = sage_port.dummy_cache_table(ds.feat_dim)
    want = np.asarray(sage_ref.forward(params, mb_ref.device, table_ref,
                                       cfg_ref))
    cfg_port = sage_port.SageConfig(feat_dim=ds.feat_dim, hidden_dim=32,
                                    num_classes=ds.num_classes,
                                    aggregate_impl=aggregate_impl,
                                    input_impl=input_impl)
    with torch.inference_mode():
        got = sage_port.forward(
            sage_port.params_from_numpy(jax_params_to_numpy(params)),
            mb_port.device.to("cpu"), table_port, cfg_port).numpy()
    assert got.shape == want.shape == (16, ds.num_classes)
    np.testing.assert_allclose(got, want, **TOL)


def test_params_layout_and_init(ds):
    cfg = sage_port.SageConfig(feat_dim=ds.feat_dim, hidden_dim=32,
                               num_classes=ds.num_classes)
    a = sage_port.init_params(cfg, torch.Generator().manual_seed(0))
    b = sage_port.init_params(cfg, torch.Generator().manual_seed(0))
    ref = sage_ref.init_params(jax.random.PRNGKey(0), sage_ref.SageConfig(
        feat_dim=ds.feat_dim, hidden_dim=32, num_classes=ds.num_classes))
    assert len(a["layers"]) == len(ref["layers"]) == 3
    for la, lb, lr in zip(a["layers"], b["layers"], ref["layers"]):
        assert torch.equal(la["w"], lb["w"])
        assert tuple(la["w"].shape) == tuple(lr["w"].shape)
        assert tuple(la["b"].shape) == tuple(lr["b"].shape)
        assert la["w"].dtype == torch.float32


def test_device_batch_to_copies_host_arrays(ds):
    _, mb = _batches(ds, "gns")
    dev = mb.device.to("cpu")
    assert dev.input_cache_slots.dtype == torch.int32
    assert dev.blocks[0].nbr_idx.dtype == torch.int32
    assert dev.blocks[0].num_dst == mb.device.blocks[0].num_dst
    dev.input_streamed.fill_(3.0)          # a copy, not a view of numpy
    assert not (mb.device.input_streamed == 3.0).all()
    assert dataclasses.is_dataclass(dev)
