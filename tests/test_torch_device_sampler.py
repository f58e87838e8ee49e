"""Port parity: the device sampling backend (``repro_torch.sampling``)
against ``repro.sampling``.

* ``mix32`` is bitwise: the port computes the uint32 chain in int64 with
  ``& 0xFFFFFFFF`` after each multiply.
* The device CSR of a generation is array-for-array the reference's.
* ``draw_lanes_plain`` gives the reference's ``draw_lanes`` rows and
  weights bit for bit: the weight is the same f32 operations in the same
  order.
* The plain slot gather accumulates over k in ascending order, product and
  sum rounded separately, as the Pallas kernel's K-innermost grid does, so
  integer-valued tables agree bit for bit with ``slot_gather_agg_pallas``
  in interpret mode.  With the draw's real-valued weights the reference's
  XLA:CPU may contract a multiply-add into an FMA, so the whole op is held
  to rtol 1e-5 / atol 1e-6 there, and its lanes bit for bit.
* ``DeviceGNSSampler`` batches are bitwise the reference's under the same
  seeds, fallback lanes and key included.

The card-only half (K3 against its plain version) is in
``test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_parity import (adj_case, assert_batches_equal,  # noqa: E402
                           sample_case)
from repro.core import sampler as samp_ref  # noqa: E402
from repro.featurestore import CacheConfig as CacheRef  # noqa: E402
from repro.graph.datasets import get_dataset  # noqa: E402
from repro.sampling import adjacency as adj_ref  # noqa: E402
from repro.sampling import kernels as kern_ref  # noqa: E402
from repro.sampling import rng as rng_ref  # noqa: E402
from repro.sampling.ref import slot_gather_agg_ref  # noqa: E402
from repro_torch.core import sampler as samp_port  # noqa: E402
from repro_torch.featurestore import CacheConfig as CachePort  # noqa: E402
from repro_torch.sampling import kernels as kern_port  # noqa: E402
from repro_torch.sampling import rng as rng_port  # noqa: E402
from repro_torch.sampling.adjacency import DeviceCacheAdj  # noqa: E402
from repro_torch.sampling.device_sampler import DeviceGNSSampler  # noqa: E402
from repro_torch.sampling.ref import slot_gather_agg_plain  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ds():
    return get_dataset("tiny", seed=0)


def _adjs(arrays):
    """The same CSR as the reference's and the port's DeviceCacheAdj."""
    ref = adj_ref.DeviceCacheAdj(*(jnp.asarray(a) for a in arrays))
    port = DeviceCacheAdj(*(torch.from_numpy(a) for a in arrays))
    return ref, port


def _samplers(ds, fanouts=(2, 3, 4), batch=32, **cache_kw):
    out = []
    for mod, cache_cls, kw in ((samp_ref, CacheRef, {}),
                               (samp_port, CachePort, {"device": "cpu"})):
        cfg = mod.SamplerConfig(fanouts=fanouts, batch_size=batch,
                                cache=cache_cls(fraction=0.05, **cache_kw),
                                backend="device")
        s = mod.make_sampler("gns", ds.graph, cfg, ds.features, ds.labels,
                             train_idx=ds.train_idx, **kw)
        s.start_epoch(0, np.random.default_rng(3))
        out.append(s)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_bitwise(seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
    ctr = rng.integers(0, 2 ** 32, size=(1000, 7), dtype=np.uint32)
    want = np.asarray(rng_ref.mix32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                    jnp.asarray(ctr)))
    got = rng_port.mix32(int(key[0]), int(key[1]),
                         torch.from_numpy(ctr.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        rng_port.murmur_fmix(torch.from_numpy(ctr.astype(np.int64))).numpy(),
        np.asarray(rng_ref.murmur_fmix(jnp.asarray(ctr))).astype(np.int64))


@pytest.mark.parametrize("cache_kw", [{}, {"shards": 2}])
def test_device_cache_adj_arrays_equal(ds, cache_kw):
    ref, port = _samplers(ds, **cache_kw)
    ga, gb = ref.store.generation, port.store.generation
    assert gb.device_adj is not None
    for name in ("indptr", "indices", "deg", "hitp"):
        a = np.asarray(getattr(ga.device_adj, name))
        b = getattr(gb.device_adj, name)
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert gb.device_adj.table_rows == gb.table.shape[0]
    assert ref.store.meter.bytes_adj_upload == port.store.meter.bytes_adj_upload
    # retire() keeps the device CSR: a queued batch still draws from it
    gb.retire()
    assert gb.device_adj is not None and gb.cache_adj is None


@pytest.mark.parametrize("k", [1, 3, 5, 15, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_draw_lanes_bitwise(k, seed):
    aj, ap = _adjs(adj_case(seed, 60, 20))
    dst, _, _, key = sample_case(seed + 10, 60, 300, k)
    rows_r, w_r = kern_ref.draw_lanes(aj, jnp.asarray(dst), jnp.asarray(key),
                                      k)
    rows_p, w_p = kern_port.draw_lanes_plain(ap, torch.from_numpy(dst), key,
                                             k)
    assert rows_p.dtype == torch.int32 and w_p.dtype == torch.float32
    np.testing.assert_array_equal(rows_p.numpy(), np.asarray(rows_r))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_r))


@pytest.mark.parametrize("b,k,d,rows", [(5, 4, 8, 16), (40, 5, 100, 30),
                                        (17, 15, 48, 64)])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_slot_gather_bitwise_on_integers(b, k, d, rows, table_dtype):
    rng = np.random.default_rng(b + k)
    cache = rng.integers(-64, 65, (rows, d)).astype(np.float32)
    lanes = rng.integers(-1, rows, (b, k)).astype(np.int32)
    w = rng.integers(-8, 9, (b, k)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[table_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[table_dtype]
    want = kern_ref.slot_gather_agg_pallas(jnp.asarray(cache, jdt),
                                           jnp.asarray(lanes), jnp.asarray(w),
                                           block_d=d, interpret=True)
    got = slot_gather_agg_plain(torch.from_numpy(cache).to(tdt),
                                torch.from_numpy(lanes), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(slot_gather_agg_ref(
            jnp.asarray(cache, jdt), jnp.asarray(lanes), jnp.asarray(w))))


@pytest.mark.parametrize("seed", [0, 1])
def test_gns_sample_agg_matches_reference(seed):
    k, rows, d = 5, 60, 24
    aj, ap = _adjs(adj_case(seed, rows, 12))
    dst, fb_rows, fb_w, key = sample_case(seed, rows, 200, k)
    cache = np.random.default_rng(seed).normal(size=(rows, d)).astype(
        np.float32)
    want = kern_ref.gns_sample_agg(
        aj, jnp.asarray(cache), jnp.asarray(dst), jnp.asarray(fb_rows),
        jnp.asarray(fb_w), jnp.asarray(key), impl="reference")
    args = (ap, torch.from_numpy(cache), torch.from_numpy(dst),
            torch.from_numpy(fb_rows), torch.from_numpy(fb_w), key)
    got = kern_port.gns_sample_agg(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the merged lanes are the reference's bit for bit
    drawn, w = kern_ref.draw_lanes(aj, jnp.asarray(dst), jnp.asarray(key), k)
    unc = (dst < 0)[:, None]
    lane_rows, lane_w = kern_port.sample_lanes_plain(*args[:1], *args[2:])
    np.testing.assert_array_equal(lane_rows.numpy(),
                                  np.where(unc, fb_rows, np.asarray(drawn)))
    np.testing.assert_array_equal(lane_w.numpy(),
                                  np.where(unc, fb_w, np.asarray(w)))
    # uncached rows take their fallback lanes as they are
    np.testing.assert_array_equal(
        got.numpy()[dst < 0], slot_gather_agg_plain(
            torch.from_numpy(cache), torch.from_numpy(fb_rows[dst < 0]),
            torch.from_numpy(fb_w[dst < 0])).numpy())


def test_device_sampler_batches_bitwise(ds):
    ref, port = _samplers(ds)
    assert isinstance(port, DeviceGNSSampler)
    assert port.pad_sizes == [tuple(p) for p in ref.pad_sizes]
    for i in range(3):
        targets = np.random.default_rng(i).choice(ds.train_idx, 32,
                                                  replace=False)
        mb_r = ref.sample(targets, np.random.default_rng(100 + i))
        mb_p = port.sample(targets, np.random.default_rng(100 + i))
        assert_batches_equal(mb_r, mb_p)
        for name in ("input_fb_rows", "input_fb_w", "sample_key"):
            a, b = getattr(mb_r.device, name), getattr(mb_p.device, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert (mb_p.device.input_fb_rows >= 0).any()   # fallback ran
    # the key stays a host array on the way to the device
    dev = mb_p.device.to("cpu")
    assert isinstance(dev.sample_key, np.ndarray)
    assert dev.input_fb_rows.dtype == torch.int32


def test_device_layer_is_forward_only_and_dispatches_by_device():
    aj, ap = _adjs(adj_case(3, 30, 8))
    dst, fb_rows, fb_w, key = sample_case(3, 30, 20, 4)
    table = torch.randn(30, 16, requires_grad=True)
    args = (torch.from_numpy(dst), torch.from_numpy(fb_rows),
            torch.from_numpy(fb_w), key)
    with pytest.raises(NotImplementedError, match="forward only"):
        kern_port.gns_sample_agg(ap, table, *args)
    n = kern_port.launches.value
    out = kern_port.gns_sample_agg(ap, table.detach(), *args)
    assert torch.equal(out, kern_port.gns_sample_agg_plain(
        ap, table.detach(), *args))
    with pytest.raises(ValueError, match="CUDA"):
        kern_port.gns_sample_agg_cuda(ap, table.detach(), *args)
    assert kern_port.launches.value == n
    with pytest.raises(ValueError, match="one key"):
        kern_port.key_words(np.zeros((2, 2), np.uint32))
