"""Port parity: the plain versions of kernels K1 and K2 against the
reference's Pallas kernels (interpret mode on the CPU).

The card-only half is ``test_torch_kernels_gpu.py``.

K1 ``cache_lookup_agg`` and K2 ``gather_agg`` accumulate over k in
ascending order in f32, as the Pallas kernels' K-innermost grids do, so
integer-valued inputs (exact products and sums) must agree bit for bit;
random f32 inputs agree within rtol 1e-5 / atol 1e-6 (XLA:CPU may contract
the reference's multiply-add into an FMA, the port rounds both steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_parity import gather_case, lookup_case  # noqa: E402
from repro.kernels import ops as ops_ref  # noqa: E402
from repro_torch.kernels import cache_lookup, gather_agg  # noqa: E402
from repro_torch.kernels import ops as ops_port  # noqa: E402
from repro_torch.kernels import ref as ref_port  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _lookup_both(cache, streamed, slots, idx, w, table_dtype="float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[table_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[table_dtype]
    want = ops_ref.cache_lookup_agg(
        jnp.asarray(cache, jdt), jnp.asarray(streamed), jnp.asarray(slots),
        jnp.asarray(idx), jnp.asarray(w), impl="pallas")
    got = ops_port.cache_lookup_agg(
        torch.from_numpy(cache).to(tdt), torch.from_numpy(streamed),
        torch.from_numpy(slots), torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.float32
    return np.asarray(want), got.numpy()


SHAPES = [(16, 64, 32, 8, 4),
          (30, 100, 48, 7, 5),       # D = 48, not a power of two
          (40, 150, 100, 12, 5)]     # D = 100, the products features


@pytest.mark.parametrize("c,s0,d,b,k", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_cache_lookup_bitwise_on_integers(c, s0, d, b, k, seed):
    want, got = _lookup_both(*lookup_case(seed, c, s0, d, b, k, True))
    np.testing.assert_array_equal(got, want)


def test_cache_lookup_bitwise_on_integers_bf16_table():
    want, got = _lookup_both(*lookup_case(2, 30, 100, 48, 7, 5, True),
                             table_dtype="bfloat16")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("miss_frac", [0.0, 0.5, 1.0])
def test_cache_lookup_float_allclose(miss_frac):
    want, got = _lookup_both(*lookup_case(3, 40, 150, 100, 12, 6, False,
                                           miss_frac))
    np.testing.assert_allclose(got, want, **TOL)


def test_cache_lookup_zero_weight_lanes_ignore_index():
    """Padded lanes (w=0) must not contribute, whatever their index/slot."""
    cache = np.full((10, 48), 1e30, np.float32)
    streamed = np.full((20, 48), -1e30, np.float32)
    slots = np.r_[np.arange(10), np.full(10, -1)].astype(np.int32)
    idx = np.tile(np.array([0, 15, 3], np.int32), (4, 1))
    w = np.zeros((4, 3), np.float32)
    want, got = _lookup_both(cache, streamed, slots, idx, w)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(got, want)


def _gather_both(feat, idx, w, table_dtype="float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[table_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[table_dtype]
    want = ops_ref.gather_agg(jnp.asarray(feat, jdt), jnp.asarray(idx),
                              jnp.asarray(w), impl="pallas")
    got = ops_port.gather_agg(torch.from_numpy(feat).to(tdt),
                              torch.from_numpy(idx), torch.from_numpy(w))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("n,d,b,k", [(64, 32, 8, 4), (100, 48, 9, 10),
                                     (120, 256, 6, 15)])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_agg_bitwise_on_integers(n, d, b, k, seed):
    want, got = _gather_both(*gather_case(seed, n, d, b, k, True))
    np.testing.assert_array_equal(got, want)


def test_gather_agg_bitwise_on_integers_bf16_table():
    want, got = _gather_both(*gather_case(4, 100, 48, 9, 10, True),
                             table_dtype="bfloat16")
    np.testing.assert_array_equal(got, want)


def test_gather_agg_float_allclose():
    want, got = _gather_both(*gather_case(5, 120, 256, 16, 10, False))
    np.testing.assert_allclose(got, want, **TOL)


def test_gather_agg_zero_weight_lanes_ignore_index():
    feat = np.full((10, 48), 1e30, np.float32)
    idx = np.tile(np.array([0, 9, 3], np.int32), (4, 1))
    w = np.zeros((4, 3), np.float32)
    want, got = _gather_both(feat, idx, w)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(got, want)


def test_cpu_dispatch_runs_the_plain_versions():
    """On CPU tensors the ops run the plain versions; the kernel wrappers
    refuse CPU tensors and count no launch."""
    feat, idx, w = (torch.from_numpy(a) for a in
                    gather_case(6, 50, 24, 5, 3, False))
    plain = ref_port.gather_agg_ref(feat, idx, w)
    assert torch.equal(ops_port.gather_agg(feat, idx, w), plain)
    cache, streamed, slots, lidx, lw = (
        torch.from_numpy(a) for a in lookup_case(6, 10, 40, 24, 5, 3, False))
    plain = ref_port.cache_lookup_agg_ref(cache, streamed, slots, lidx, lw)
    assert torch.equal(ops_port.cache_lookup_agg(cache, streamed, slots, lidx,
                                                 lw), plain)
    n1, n2 = cache_lookup.launches.value, gather_agg.launches.value
    with pytest.raises(ValueError):
        gather_agg.gather_agg_cuda(feat, idx, w)
    with pytest.raises(ValueError):
        cache_lookup.cache_lookup_agg_cuda(cache, streamed, slots, lidx, lw)
    assert (cache_lookup.launches.value, gather_agg.launches.value) == (n1, n2)
