"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card only (``-m gpu``; every test skips without a card).  Needs torch and
no jax, so it runs on the GPU host:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The kernels and the plain versions round each product and each sum
separately, in ascending k, so K1, K2 and K3 are held bit for bit
(``torch.equal``) on integer-valued f32, random f32 and bf16 tables: K3
computes its weights with the plain version's f32 operations in the same
order, so its lanes agree bit for bit too.  K1, K2 and K3 run on row tiles
with two access paths (4 columns per access when D % 4 == 0 and every
table is aligned, else one); every case asserts, through the path
counters, the path ``access_path`` (K1: ``lookup_access_path``) names for
it, and the cases give both paths ragged last tiles, B = 1, K = 1 and 32
(and for K1 and K2 K > 32, whose lanes go in chunks of 32), D up to 520,
bf16 tables and tables that are views at an unaligned offset; K1 also all
hits, all misses and a mix, the main path's shapes, and LADIES's layer 0
(a 1-row dummy cache, every lane a miss, K = 32, most lanes masked).  K4 (flash attention)
sums its online softmax in another order than the plain version's full
softmax: f32 is held to 2e-5 (3e-5 for odd
lengths), the JAX kernel tests' tolerances.  In bf16 both keep p.v in f32
and round each output once, so they differ by at most one bf16 ulp
(<= 2^-7 of the value): rtol 1e-2, atol 4e-3.  K4 has three routes (split-KV
for at most 16 rows per (batch, kv head), the tensor cores for bf16 with
more, the CUDA cores for float32 with more); every case asserts, through the
route counters, the route ``k4_route`` names for it, and the cases give
each route MQA, a window, odd lengths, a poisoned tail past ``kv_len`` and
head dims 120 and 256 in every dtype it takes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (adj_case, gather_case,  # noqa: E402
                           ladies_case, lookup_case, requires_cuda,
                           sample_case)
from repro_torch.kernels import cache_lookup, gather_agg, ops  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.sampling import kernels as k3  # noqa: E402
from repro_torch.sampling.adjacency import DeviceCacheAdj  # noqa: E402

SHAPES = [(16, 64, 32, 8, 4), (30, 100, 48, 7, 5), (40, 150, 100, 12, 5)]


def k1_case(dev, seed, c, s0, d, b, k, exact, table_dtype, miss_frac=0.5):
    """K1's operands on the card (``lookup_case``), the cache in
    ``table_dtype``."""
    cache, streamed, slots, idx, w = (
        torch.from_numpy(a).to(dev)
        for a in lookup_case(seed, c, s0, d, b, k, exact, miss_frac))
    return cache.to(table_dtype), streamed, slots, idx, w


def hold_k1(cache, streamed, slots, idx, w, path: str) -> None:
    """One K1 launch on ``path`` (asserted through ``path_calls``), bit for
    bit its plain version."""
    assert cache_lookup.lookup_access_path(cache, streamed) == path
    n0 = cache_lookup.launches.value
    p0 = path_counts(cache_lookup.path_calls)
    got = cache_lookup.cache_lookup_agg_cuda(cache, streamed, slots, idx, w)
    want = cache_lookup.cache_lookup_agg_plain(cache, streamed, slots, idx, w)
    torch.cuda.synchronize()
    assert cache_lookup.launches.value == n0 + 1
    assert_took(cache_lookup.path_calls, p0, path)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("c,s0,d,b,k", SHAPES + [(305, 4224, 100, 704, 5),
                                           (20, 80, 300, 9, 5)])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_cache_lookup_kernel_matches_plain_on_card(c, s0, d, b, k,
                                                   table_dtype):
    dev = requires_cuda()
    for exact in (True, False):
        hold_k1(*k1_case(dev, 7, c, s0, d, b, k, exact, table_dtype),
                "vector")


# (c, s0, d, b, k): B = 1 with K = 1; a ragged last tile (b = 3001 at
# d = 100: tiles of 40 rows, the last of 1); K = 32, 40 (chunks of 32 and
# 8) and 70 (32, 32, 6) on both paths; the scalar path at d = 30, 33 and 1;
# D above 256; tiles of 64 rows at d = 4 with K = 32
K1_CASES = [(20, 80, 100, 1, 1), (40, 300, 100, 3001, 5),
            (30, 200, 64, 50, 32), (30, 200, 36, 50, 40),
            (30, 200, 64, 20, 70), (30, 200, 33, 20, 70),
            (25, 100, 30, 200, 5), (25, 100, 1, 9, 3),
            (64, 400, 520, 45, 7), (100, 2000, 4, 20000, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,s0,d,b,k", K1_CASES)
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_cache_lookup_kernel_shapes_on_card(c, s0, d, b, k, table_dtype):
    dev = requires_cuda()
    path = "vector" if d % 4 == 0 else "scalar"
    for exact in (True, False):
        hold_k1(*k1_case(dev, 17, c, s0, d, b, k, exact, table_dtype), path)


@pytest.mark.gpu
@pytest.mark.parametrize("miss_frac", [0.0, 1.0, 0.5])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_cache_lookup_hits_and_misses_on_card(miss_frac, table_dtype):
    """Every lane a hit (the cache covers all 200 input rows), every lane a
    miss, and half and half."""
    dev = requires_cuda()
    for exact in (True, False):
        args = k1_case(dev, 5, 200, 200, 100, 300, 5, exact, table_dtype,
                       miss_frac)
        _, _, slots, idx, _ = args
        hits = float((slots.long()[idx.long()] >= 0).float().mean())
        lo, hi = {0.0: (1.0, 1.0), 1.0: (0.0, 0.0), 0.5: (0.2, 0.8)}[miss_frac]
        assert lo <= hits <= hi
        hold_k1(*args, "vector")


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["cache", "streamed"])
@pytest.mark.parametrize("offset,path", [(1, "scalar"), (2, "scalar"),
                                         (4, "vector")])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_cache_lookup_unaligned_table_on_card(table, offset, path,
                                              table_dtype):
    """The cache or the streamed rows as a view 1, 2 or 4 elements into its
    buffer: either one unaligned sends the whole launch down the scalar
    path (the offsets of the K2 test of the same name)."""
    dev = requires_cuda()
    cache, streamed, slots, idx, w = k1_case(dev, 11, 60, 400, 64, 500, 10,
                                             False, table_dtype)
    if table == "cache":
        cache = unaligned_copy(cache, offset)
    else:
        streamed = unaligned_copy(streamed, offset)
    hold_k1(cache, streamed, slots, idx, w, path)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [176000, 90112, 22528])
def test_cache_lookup_main_path_shapes_on_card(b):
    """The main path's shapes (preset paper_train: the training shape of
    the host-fused input, buckets 512 and 128): K = 5, D = 100, a 305-row
    cache over 6 b input rows."""
    dev = requires_cuda()
    for exact in (True, False):
        args = k1_case(dev, b, 305, 6 * b, 100, b, 5, exact, torch.float32)
        for table_dtype in (torch.float32, torch.bfloat16):
            hold_k1(args[0].to(table_dtype), *args[1:], "vector")


@pytest.mark.gpu
@pytest.mark.parametrize("s0,d,b,k", [(2536, 100, 2024, 32),
                                      (1512, 100, 1000, 32),
                                      (90, 64, 50, 32)])
def test_cache_lookup_ladies_shape_on_card(s0, d, b, k):
    """LADIES's layer 0 with no feature store (preset paper_train, batch
    1000, layer_size 512, lane_cap 32: 2,024 rows of 32 lanes over 2,536
    streamed rows): the 1-row dummy cache, every lane a miss, about a
    quarter of the lanes live and the rest masked (idx 0, w 0), some rows
    with no live lane."""
    dev = requires_cuda()
    for exact in (True, False):
        cache, streamed, slots, idx, w = (
            torch.from_numpy(a).to(dev)
            for a in ladies_case(b, s0, d, b, k, exact))
        assert not bool((slots >= 0).any())
        live = float((w != 0).float().mean())
        assert 0.1 < live < 0.4 and bool(((w != 0).sum(1) == 0).any())
        hold_k1(cache, streamed, slots, idx, w, "vector")


# (n, d, b, k): both access paths (d % 4), B = 1, K = 1, 32 and above 32
# (lanes in chunks of 32), D above 256, a ragged last tile (b = 3001 at
# d = 100: tiles of 2 rows, the last of 1), tiles of 64 rows at d = 4 with
# K = 32
K2_CASES = [(64, 32, 8, 4), (100, 48, 9, 10), (704, 256, 64, 10),
            (64, 300, 33, 15), (50, 30, 70, 5), (50, 33, 1, 1),
            (300, 520, 45, 7), (400, 100, 3001, 5), (64, 64, 300, 32),
            (64, 36, 50, 40), (64, 33, 20, 70), (64, 4, 20000, 32)]


def path_counts(counters: dict) -> dict:
    return {name: c.value for name, c in counters.items()}


def assert_took(counters: dict, before: dict, path: str) -> None:
    """Exactly one launch since ``before``, on ``path``."""
    assert {name: c.value - before[name] for name, c in counters.items()
            } == {name: int(name == path) for name in counters}


def unaligned_copy(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t`` copied into a contiguous view that starts ``offset`` elements
    into a fresh buffer."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b,k", K2_CASES)
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_gather_agg_kernel_matches_plain_on_card(n, d, b, k, table_dtype):
    dev = requires_cuda()
    for exact in (True, False):
        feat, idx, w = (torch.from_numpy(a).to(dev)
                        for a in gather_case(8, n, d, b, k, exact))
        feat = feat.to(table_dtype)
        path = gather_agg.access_path(feat)
        assert path == ("vector" if d % 4 == 0 else "scalar")
        n0 = gather_agg.launches.value
        p0 = path_counts(gather_agg.path_calls)
        got = gather_agg.gather_agg_cuda(feat, idx, w)
        want = gather_agg.gather_agg_plain(feat, idx, w)
        torch.cuda.synchronize()
        assert gather_agg.launches.value == n0 + 1
        assert_took(gather_agg.path_calls, p0, path)
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("offset,path", [(1, "scalar"), (2, "scalar"),
                                         (4, "vector")])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_gather_agg_unaligned_table_on_card(offset, path, table_dtype):
    """A table that starts 1, 2 or 4 elements into its buffer: 4 elements
    keep 16-byte (f32) and 8-byte (bf16) alignment, 1 keeps neither, 2
    keeps 8 bytes in f32 (too few) and 4 in bf16 (too few)."""
    dev = requires_cuda()
    feat, idx, w = (torch.from_numpy(a).to(dev)
                    for a in gather_case(11, 200, 64, 500, 10, False))
    feat = unaligned_copy(feat.to(table_dtype), offset)
    assert gather_agg.access_path(feat) == path
    p0 = path_counts(gather_agg.path_calls)
    got = gather_agg.gather_agg_cuda(feat, idx, w)
    want = gather_agg.gather_agg_plain(feat, idx, w)
    torch.cuda.synchronize()
    assert_took(gather_agg.path_calls, p0, path)
    assert torch.equal(got, want)


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


# (rows, d, b, k): both access paths, B = 1 with K = 1, D above 256, a
# ragged last tile (b = 3001 at d = 100: tiles of 40 rows, the last of 1),
# K = 32 with tiles of 64 rows at d = 4
K3_CASES = [(60, 24, 200, 5), (305, 100, 4096, 5), (64, 300, 33, 15),
            (40, 48, 70, 32), (60, 30, 200, 5), (40, 33, 1, 1),
            (64, 520, 50, 7), (305, 100, 3001, 5), (100, 4, 20000, 32)]


def k3_case(dev, rows, b, k):
    """K3's operands on the card: a CSR over ``rows`` table rows, dst_rows,
    fallback lanes and a key."""
    adj = DeviceCacheAdj(*(torch.from_numpy(a).to(dev)
                           for a in adj_case(rows, rows, 3 * k)))
    dst, fb_rows, fb_w, key = sample_case(rows + 1, rows, b, k)
    dst, fb_rows, fb_w = (torch.from_numpy(a).to(dev)
                          for a in (dst, fb_rows, fb_w))
    return adj, dst, fb_rows, fb_w, key


def hold_k3(adj, table, dst, fb_rows, fb_w, key) -> None:
    """One K3 launch on ``table``: its path, lanes and output bit for bit."""
    dev = table.device
    b, k = fb_rows.shape
    path = k3.access_path(table)
    lane_rows = torch.empty((b, k), dtype=torch.int32, device=dev)
    lane_w = torch.empty((b, k), dtype=torch.float32, device=dev)
    n0 = k3.launches.value
    p0 = path_counts(k3.path_calls)
    got = k3.gns_sample_agg_cuda(adj, table, dst, fb_rows, fb_w, key,
                                 lane_rows, lane_w)
    want_rows, want_w = k3.sample_lanes_plain(adj, dst, fb_rows, fb_w, key)
    want = k3.gns_sample_agg_plain(adj, table, dst, fb_rows, fb_w, key)
    torch.cuda.synchronize()
    assert k3.launches.value == n0 + 1
    assert_took(k3.path_calls, p0, path)
    assert torch.equal(lane_rows, want_rows)
    assert torch.equal(lane_w, want_w)
    assert torch.equal(got, want)
    assert torch.equal(k3.gns_sample_agg(adj, table, dst, fb_rows, fb_w,
                                         key), want)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,b,k", K3_CASES)
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_gns_sample_agg_kernel_matches_plain_on_card(rows, d, b, k,
                                                     table_dtype):
    dev = requires_cuda()
    adj, dst, fb_rows, fb_w, key = k3_case(dev, rows, b, k)
    rng = np.random.default_rng(d)
    for exact in (True, False):
        table = (rng.integers(-64, 65, (rows, d)) if exact
                 else rng.normal(size=(rows, d))).astype(np.float32)
        table = torch.from_numpy(table).to(dev, dtype=table_dtype)
        assert k3.access_path(table) == ("vector" if d % 4 == 0
                                         else "scalar")
        hold_k3(adj, table, dst, fb_rows, fb_w, key)


@pytest.mark.gpu
@pytest.mark.parametrize("offset,path", [(1, "scalar"), (2, "scalar"),
                                         (4, "vector")])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_gns_sample_agg_unaligned_table_on_card(offset, path, table_dtype):
    """K3 on a table view 1, 2 or 4 elements into its buffer (the paths of
    the K2 test of the same name)."""
    dev = requires_cuda()
    adj, dst, fb_rows, fb_w, key = k3_case(dev, 80, 900, 5)
    table = torch.from_numpy(np.random.default_rng(3).normal(
        size=(80, 64)).astype(np.float32)).to(dev, dtype=table_dtype)
    table = unaligned_copy(table, offset)
    assert k3.access_path(table) == path
    hold_k3(adj, table, dst, fb_rows, fb_w, key)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,b,k", [(305, 100, 4096, 5),
                                        (60, 30, 200, 5), (40, 48, 70, 32)])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_gns_sample_agg_row_range_on_card(rows, d, b, k, table_dtype):
    """K3 over a row range (one shard of a row-sharded table) against its
    plain version, bit for bit: the whole range given explicitly is
    today's call, an empty range writes zeros, a one-row range and each
    of 4 shards match the plain version; on exact operands the shards'
    partials sum to the full call bit for bit."""
    from _torch_parity import adj_case, exact_k3
    dev = requires_cuda()
    adj, dst, fb_rows, fb_w, key = k3_case(dev, rows, b, k)
    table = torch.from_numpy(np.random.default_rng(d).integers(
        -64, 65, (rows, d)).astype(np.float32)).to(dev, dtype=table_dtype)
    full = k3.gns_sample_agg_cuda(adj, table, dst, fb_rows, fb_w, key)
    assert torch.equal(full, k3.gns_sample_agg_cuda(
        adj, table, dst, fb_rows, fb_w, key, row_lo=0, row_count=rows))
    n0 = k3.launches.value
    empty = k3.gns_sample_agg_cuda(adj, table[:0], dst, fb_rows, fb_w, key,
                                   row_lo=rows // 2, row_count=0)
    torch.cuda.synchronize()
    assert k3.launches.value == n0 + 1
    assert torch.equal(empty, torch.zeros_like(full))
    rps = -(-rows // 4)
    ranges = [(lo, min(rps, rows - lo)) for lo in range(0, rows, rps)]
    for lo, n in [(rows - 1, 1)] + ranges:
        part = table[lo:lo + n].contiguous()
        got = k3.gns_sample_agg_cuda(adj, part, dst, fb_rows, fb_w, key,
                                     row_lo=lo, row_count=n)
        want = k3.gns_sample_agg_plain(adj, part, dst, fb_rows, fb_w, key,
                                       row_lo=lo, row_count=n)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (lo, n)
    ptr, idx, _, _ = adj_case(rows, rows, 3 * k)
    ptr, idx, deg, hitp, w_int = exact_k3(ptr, idx, fb_w.cpu().numpy(), k)
    adj_x = DeviceCacheAdj(*(torch.from_numpy(a).to(dev)
                             for a in (ptr, idx, deg, hitp)))
    w_int = torch.from_numpy(w_int).to(dev)
    full = k3.gns_sample_agg_cuda(adj_x, table, dst, fb_rows, w_int, key)
    total = sum(k3.gns_sample_agg_cuda(
        adj_x, table[lo:lo + n].contiguous(), dst, fb_rows, w_int, key,
        row_lo=lo, row_count=n) for lo, n in ranges)
    torch.cuda.synchronize()
    assert torch.equal(total, full)


@pytest.mark.gpu
def test_gns_sample_agg_wrapper_checks_its_operands_on_card():
    dev = requires_cuda()
    adj = DeviceCacheAdj(*(torch.from_numpy(a).to(dev)
                           for a in adj_case(1, 30, 8)))
    table = torch.randn(30, 16, device=dev)
    dst, fb_rows, fb_w, key = sample_case(1, 30, 10, 33)
    dst, fb_rows, fb_w = (torch.from_numpy(a).to(dev)
                          for a in (dst, fb_rows, fb_w))
    with pytest.raises(ValueError, match="lanes"):
        k3.gns_sample_agg_cuda(adj, table, dst, fb_rows, fb_w, key)
    with pytest.raises(ValueError):
        k3.gns_sample_agg_cuda(adj, table[:29].contiguous(), dst,
                               fb_rows[:, :4].contiguous(),
                               fb_w[:, :4].contiguous(), key)
    with pytest.raises(ValueError, match="range"):
        k3.gns_sample_agg_cuda(adj, table[:10].contiguous(), dst,
                               fb_rows[:, :4].contiguous(),
                               fb_w[:, :4].contiguous(), key, row_lo=25,
                               row_count=10)
    with pytest.raises(TypeError):
        k3.gns_sample_agg_cuda(adj, table, dst.long(),
                               fb_rows[:, :4].contiguous(),
                               fb_w[:, :4].contiguous(), key)


@pytest.mark.gpu
def test_cache_lookup_gradient_on_card_matches_cpu():
    """K1's backward is the same plain-torch VJP on both devices: the
    card's gradient (K1 forward) equals the CPU's (plain forward) within
    the tolerance of index_add_'s unordered sums on the card."""
    dev = requires_cuda()
    arrays = lookup_case(12, 20, 80, 16, 6, 4, False)
    grads = []
    for device in ("cpu", dev):
        cache, streamed, slots, idx, w = (torch.from_numpy(a).to(device)
                                          for a in arrays)
        leaves = [t.requires_grad_(True) for t in (cache, streamed, w)]
        out = ops.cache_lookup_agg(cache, streamed, slots, idx, w)
        (out ** 2).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


# (b, hq, hkv, sq, sk, dh, causal, window, kv_len, q_offset): the JAX
# kernel tests' cases (MHA, GQA, MQA, window, cross, one-token decode, odd
# lengths, a poisoned tail past kv_len), the serve shape of the enc-dec
# decoder's cross-attention and danube's head dim 120
K4_CASES = [
    (1, 2, 2, 64, 64, 32, True, None, None, None),
    (2, 4, 2, 128, 128, 64, True, None, None, None),
    (1, 8, 1, 64, 64, 64, True, None, None, None),
    (1, 2, 2, 128, 128, 32, True, 32, None, None),
    (2, 2, 2, 32, 96, 32, False, None, None, None),
    (1, 4, 2, 1, 256, 64, True, None, None, None),
    (1, 2, 1, 37, 53, 32, True, None, None, None),
    (1, 2, 2, 32, 64, 32, False, None, 48, 16),
    (4, 16, 16, 1, 1024, 64, False, None, None, None),
    (1, 4, 1, 70, 300, 120, True, 64, 290, 200),
    (2, 4, 4, 3, 40, 256, True, None, None, None),
    # split-KV route (G * Sq <= 16): MQA, a window, odd lengths, a poisoned
    # tail, Dh 120 and 256, a chunk that the rows at position 127 see none
    # of (keys 128-130), and a row that sees no key at all
    (2, 8, 1, 1, 300, 64, True, None, None, None),
    (1, 4, 2, 2, 500, 64, True, 100, None, None),
    (1, 2, 1, 7, 53, 32, True, None, None, None),
    (2, 4, 4, 1, 200, 64, False, None, 150, 149),
    (1, 4, 1, 3, 300, 120, True, 64, 290, 200),
    (2, 4, 4, 1, 400, 256, False, None, 333, 332),
    (1, 4, 2, 4, 131, 32, True, None, None, None),
    (1, 2, 2, 1, 16, 32, False, None, 0, 0),
    # many rows at Dh 256 (tensor cores in bf16, CUDA cores in f32), with a
    # window and a poisoned tail; several row and key tiles under a causal
    # mask at qwen2's head dim
    (1, 4, 2, 40, 90, 256, True, None, None, None),
    (1, 2, 1, 100, 200, 256, True, 50, 180, 80),
    (1, 28, 4, 300, 300, 128, True, None, None, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", K4_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(case, dtype):
    dev = requires_cuda()
    b, hq, hkv, sq, sk, dh, causal, window, kv_len, q_offset = case
    rng = np.random.default_rng(sk + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, s, dh)).astype(
        np.float32)).to(dev, dtype=dtype)
        for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    if kv_len is not None:
        k[:, :, kv_len:] = 1e5                 # poison the masked tail
        v[:, :, kv_len:] = 1e5
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=q_offset)
    route = k4.k4_route(hq // hkv * sq, dtype)
    n0 = k4.launches.value
    r0 = {name: c.value for name, c in k4.route_calls.items()}
    got = k4.flash_attention_cuda(q, k, v, **kw)
    want = k4.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert k4.launches.value == n0 + 1
    assert {name: c.value - r0[name] for name, c in k4.route_calls.items()
            } == {name: int(name == route) for name in k4.ROUTES}
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        rtol, atol = 1e-2, 4e-3
    else:
        rtol = atol = 3e-5 if sq == 37 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
def test_flash_attention_wrapper_checks_its_operands_on_card():
    dev = requires_cuda()
    q, k, v = (torch.randn(1, 2, 8, 64, device=dev) for _ in range(3))
    for dh in (12, 264):
        bad = torch.randn(1, 2, 8, dh, device=dev)
        with pytest.raises(ValueError, match="head dim"):
            k4.flash_attention_cuda(bad, bad, bad)
    with pytest.raises(TypeError):
        k4.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        k4.flash_attention_cuda(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        k4.flash_attention_cuda(q, k, v, kv_len=9)
    with pytest.raises(ValueError, match="multiple"):
        k4.flash_attention_cuda(torch.randn(1, 3, 8, 64, device=dev), k, v)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.flash_attention(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (1, 28, 4, 300, 300, 128, True, None, None, None),
    (1, 8, 2, 200, 333, 120, True, 64, 300, 90),
    (1, 2, 1, 37, 53, 32, True, None, None, None),
    (1, 4, 2, 40, 90, 256, True, None, None, None),
])
def test_tensor_core_route_matches_the_cuda_core_route_on_card(case):
    """Routes (ii) and (iii) by name on the same bf16 operands: each rounds
    its output to bf16 once (the tensor cores also round p), so they agree
    within the bf16 limit."""
    dev = requires_cuda()
    b, hq, hkv, sq, sk, dh, causal, window, kv_len, q_offset = case
    rng = np.random.default_rng(sq + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, s, dh)).astype(
        np.float32)).to(dev, dtype=torch.bfloat16)
        for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=q_offset)
    tc0 = k4.route_calls["tensor_core"].value
    simt0 = k4.route_calls["simt"].value
    tc = k4.flash_attention_tensor_core(q, k, v, **kw)
    simt = k4.flash_attention_simt(q, k, v, **kw)
    torch.cuda.synchronize()
    assert k4.route_calls["tensor_core"].value == tc0 + 1
    assert k4.route_calls["simt"].value == simt0 + 1
    torch.testing.assert_close(tc.float(), simt.float(), rtol=1e-2,
                               atol=4e-3)


@pytest.mark.gpu
def test_flash_attention_routes_check_their_operands_on_card():
    dev = requires_cuda()
    q = torch.randn(1, 4, 8, 64, device=dev)
    k, v = (torch.randn(1, 1, 8, 64, device=dev) for _ in range(2))
    with pytest.raises(TypeError, match="bfloat16"):
        k4.flash_attention_tensor_core(q, k, v)
    with pytest.raises(ValueError, match="at most 16 rows"):
        k4.flash_attention_split_kv(q, k, v)
    flat = torch.randn(q.numel() + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        k4.flash_attention_cuda(flat[1:].view(q.shape), k, v)


@pytest.mark.gpu
def test_flash_attention_op_launches_the_kernel_on_card(monkeypatch):
    """A CUDA tensor at ops.flash_attention never reaches the plain
    version: with the plain version made to raise, the op still answers,
    the counter moves by one, and the result is the plain version's."""
    dev = requires_cuda()
    q = torch.randn(2, 4, 1, 64, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(2, 2, 50, 64, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    want = k4.flash_attention_plain(q, k, v, causal=False, kv_len=50,
                                    q_offset=49)

    def refuse(*args, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ops, "flash_attention_plain", refuse)
    n0 = k4.launches.value
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert k4.launches.value == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=4e-3)
