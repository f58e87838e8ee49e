"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card only (``-m gpu``; every test skips without a card).  Needs torch and
no jax, so it runs on the GPU host:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The kernels and the plain versions round each product and each sum
separately, in ascending k, so integer-valued f32 must agree bit for bit;
random f32 and bf16 tables are held to rtol 1e-5 / atol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import gather_case, lookup_case, requires_cuda  # noqa: E402
from repro_torch.kernels import cache_lookup, gather_agg  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(16, 64, 32, 8, 4), (30, 100, 48, 7, 5), (40, 150, 100, 12, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,s0,d,b,k", SHAPES + [(305, 4224, 100, 704, 5),
                                           (20, 80, 300, 9, 5)])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_cache_lookup_kernel_matches_plain_on_card(c, s0, d, b, k,
                                                   table_dtype):
    dev = requires_cuda()
    for exact in (True, False):
        cache, streamed, slots, idx, w = (
            torch.from_numpy(a).to(dev)
            for a in lookup_case(7, c, s0, d, b, k, exact))
        cache = cache.to(table_dtype)
        n0 = cache_lookup.launches.value
        got = cache_lookup.cache_lookup_agg_cuda(cache, streamed, slots, idx, w)
        want = cache_lookup.cache_lookup_agg_plain(cache, streamed, slots,
                                                   idx, w)
        torch.cuda.synchronize()
        assert cache_lookup.launches.value == n0 + 1
        if exact:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b,k", [(64, 32, 8, 4), (100, 48, 9, 10),
                                     (704, 256, 64, 10), (64, 300, 33, 15)])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_gather_agg_kernel_matches_plain_on_card(n, d, b, k, table_dtype):
    dev = requires_cuda()
    for exact in (True, False):
        feat, idx, w = (torch.from_numpy(a).to(dev)
                        for a in gather_case(8, n, d, b, k, exact))
        feat = feat.to(table_dtype)
        n0 = gather_agg.launches.value
        got = gather_agg.gather_agg_cuda(feat, idx, w)
        want = gather_agg.gather_agg_plain(feat, idx, w)
        torch.cuda.synchronize()
        assert gather_agg.launches.value == n0 + 1
        if exact:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_kernel_wrappers_check_their_operands_on_card():
    dev = requires_cuda()
    feat, idx, w = (torch.from_numpy(a).to(dev)
                    for a in gather_case(9, 50, 24, 5, 3, False))
    with pytest.raises(TypeError):
        gather_agg.gather_agg_cuda(feat, idx.long(), w)
    with pytest.raises(ValueError):
        gather_agg.gather_agg_cuda(feat.t(), idx, w)
    with pytest.raises(ValueError):
        gather_agg.gather_agg_cuda(feat, idx, w.cpu())
