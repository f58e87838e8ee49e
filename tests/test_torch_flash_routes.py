"""K4's three CUDA routes, from the CPU: the routing rule, the split-KV
plan, and route (i)'s split-KV algebra in plain PyTorch
(``flash_attention_split_kv_plain``: partials per split, then the combine)
against the kernel's plain version and the reference's Pallas kernel
(``interpret=True``), on the same numpy inputs.  The kernels themselves run
only on the card (``tests/test_torch_kernels_gpu.py``).

Tolerances: 2e-5 in f32, the JAX kernel tests' limit (the split partials
and the combine sum in another order than the full softmax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402

TOL = 2e-5
BF16, F32 = torch.bfloat16, torch.float32


def _qkv(seed, b, hq, hkv, sq, sk, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, dh)).astype(np.float32)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]


@pytest.mark.parametrize("g,sq", [(1, 1), (16, 1), (4, 4), (2, 8), (1, 16),
                                  (8, 2)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_few_rows_take_the_split_kv_route(g, sq, dtype):
    """Up to 16 rows per (batch, kv head), in either dtype: split-KV.  The
    served cross-attention (G = 1, Sq = 1) is one of them."""
    assert k4.k4_route(g * sq, dtype) == "split_kv"


@pytest.mark.parametrize("g,sq", [(7, 4096), (4, 8192), (1, 17), (8, 64),
                                  (2, 37), (17, 1)])
def test_many_rows_route_by_dtype(g, sq):
    """More rows: bf16 on the tensor cores ((b) qwen2-7b is G=7 over 4096
    positions, (c) danube3 G=4 over 8192), float32 on the CUDA cores."""
    assert k4.k4_route(g * sq, BF16) == "tensor_core"
    assert k4.k4_route(g * sq, F32) == "simt"
    assert set(k4.ROUTES) == {"split_kv", "tensor_core", "simt"}


def test_split_plan_at_the_serve_shape():
    """B=4 x 16 kv heads, 1024 keys, Dh 64 bf16: 4 chunks of 256 keys, 256
    blocks of 8 warps (one 32-key tile each) on 132 SMs."""
    chunk, splits = k4.split_plan(64, 64, 2, 1024)
    assert (chunk, splits) == (256, 4)
    assert 64 * splits >= k4.H100_SMS
    assert chunk // k4.SPLIT_TILE == k4.split_ways(1)


@pytest.mark.parametrize("blocks,dh,elt,n_keys", [
    (64, 64, 2, 1024), (64, 64, 4, 1024), (1, 128, 2, 4096),
    (8, 256, 4, 5000), (2048, 64, 2, 1024), (4, 120, 2, 300),
    (1, 64, 2, 40), (16, 32, 2, 0), (1, 8, 2, 20000)])
def test_split_plan_fills_the_card_and_fits_shared_memory(blocks, dh, elt,
                                                          n_keys):
    chunk, splits = k4.split_plan(blocks, dh, elt, n_keys)
    tiles = max(-(-n_keys // k4.SPLIT_TILE), 1)
    assert chunk % k4.SPLIT_TILE == 0 and splits >= 1
    assert chunk * splits >= n_keys                     # every key covered
    assert chunk * (splits - 1) < max(n_keys, 1)        # no empty chunk
    # about two blocks per SM (at least one), unless the keys run out first
    assert blocks * splits >= k4.H100_SMS or splits == tiles
    pitch = -(-dh * elt // 128) * 128 + 16       # the kernel's padded rows
    assert 2 * chunk * pitch <= max(k4.SPLIT_SMEM_BYTES,
                                    2 * k4.SPLIT_TILE * pitch)


@pytest.mark.parametrize("sq,sk,causal,window,kv_len,q_offset,want", [
    (1, 1024, False, None, 1024, 1023, (0, 1024)),
    (4, 131, True, None, 131, 127, (0, 131)),
    (1, 500, True, 100, 500, 499, (400, 500)),
    (3, 300, True, 64, 290, 200, (137, 203)),
    (1, 200, False, None, 150, 149, (0, 150)),
    (1, 16, False, None, 0, 0, (0, 0)),
])
def test_visible_keys(sq, sk, causal, window, kv_len, q_offset, want):
    assert k4.visible_keys(sq, sk, causal=causal, window=window,
                           kv_len=kv_len, q_offset=q_offset) == want


# (b, hq, hkv, sq, sk, dh, causal, window, kv_len, q_offset, chunk, ways,
#  whole): whole=True splits all of [0, Sk) rather than the visible keys, so
# some splits lie wholly past kv_len or outside the window
SPLIT_CASES = [
    ("serve", 4, 16, 16, 1, 1024, 64, False, None, None, None, 128, 4,
     False),
    ("mqa", 2, 8, 1, 1, 300, 64, True, None, None, None, 64, 2, False),
    ("kv_len-tail", 2, 4, 4, 1, 200, 64, False, None, 150, 149, 32, 4,
     True),
    ("window", 1, 4, 2, 2, 500, 64, True, 100, None, None, 96, 4, True),
    ("dh120", 1, 4, 1, 3, 300, 120, True, 64, 290, 200, 32, 1, False),
    ("last-split-masked", 1, 4, 2, 4, 131, 32, True, None, None, None, 32,
     2, False),
    ("uneven", 1, 2, 1, 7, 53, 32, True, None, None, None, 32, 1, True),
    ("no-key", 1, 2, 2, 1, 16, 32, False, None, 0, 0, 32, 4, True),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_kv_algebra_matches_plain(case):
    (_, b, hq, hkv, sq, sk, dh, causal, window, kv_len, q_offset, chunk,
     ways, whole) = case
    q, k, v = (torch.from_numpy(a) for a in _qkv(sk + dh, b, hq, hkv, sq, sk,
                                                 dh))
    kw = dict(causal=causal, window=window, kv_len=kv_len, q_offset=q_offset)
    if kv_len is not None:
        k[:, :, kv_len:] = 1e5                 # poison the masked tail
        v[:, :, kv_len:] = 1e5
    _, kl, qo = k4._defaults(q, k, None, kv_len, q_offset)
    lo, hi = (0, sk) if whole else k4.visible_keys(
        sq, sk, causal=causal, window=window, kv_len=kl, q_offset=qo)
    got = k4.flash_attention_split_kv_plain(q, k, v, **kw, col_begin=lo,
                                            col_end=hi, chunk=chunk,
                                            ways=ways)
    want = k4.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_split_kv_algebra_has_fully_masked_partials():
    """Splits that a row sees nothing of enter the combine with m = -1e30
    and l = 0, and leave no NaN: rows at position 127 see none of the last
    chunk (keys 128-130) at the wrapper's own plan, and whole-range splits
    past kv_len are masked for every row."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4, 2, 4, 131, 32))
    chunk, splits = k4.split_plan(2, 32, 4, 131)
    assert (chunk, splits) == (32, 5)
    m, l, acc = k4.split_kv_partials_plain(q, k, v, causal=True,
                                           chunk=chunk, ways=2)
    assert m.shape[0] == splits
    # the last split, for the rows at position 127 (query 0)
    assert (m[4, ..., 0, :] == -1e30).all() and (l[4, ..., 0, :] == 0).all()
    assert (acc[4, ..., 0, :] == 0).all()
    assert (l[4, ..., 1:, :] > 0).all()
    out = k4.split_kv_combine_plain(m, l, acc)
    assert torch.isfinite(out).all()
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 2, 4, 4, 1, 200, 64))
    m, l, _ = k4.split_kv_partials_plain(q, k, v, causal=False, kv_len=150,
                                         q_offset=149, chunk=32, ways=4)
    assert (l[-2:] == 0).all() and (m[-2:] == -1e30).all()
    assert (l[:-2] > 0).all()


def test_split_kv_algebra_matches_pallas_kernel():
    """Route (i)'s algebra against the reference's Pallas kernel
    (interpret mode) at a decode shape with a window, a kv_len tail and
    GQA."""
    b, hq, hkv, sq, sk, dh = 1, 8, 2, 1, 256, 64
    qn, kn, vn = _qkv(11, b, hq, hkv, sq, sk, dh)
    kw = dict(causal=True, window=96, kv_len=200, q_offset=199)
    jq = jnp.pad(jnp.asarray(qn), ((0, 0), (0, 0), (0, 15), (0, 0)))
    want = flash_attention_pallas(jq, jnp.asarray(kn), jnp.asarray(vn),
                                  block_q=16, block_k=32, interpret=True,
                                  **kw)[:, :, :sq]
    lo, hi = k4.visible_keys(sq, sk, causal=True, window=96, kv_len=200,
                             q_offset=199)
    chunk, _ = k4.split_plan(b * hkv, dh, 4, hi - lo)
    got = k4.flash_attention_split_kv_plain(
        *(torch.from_numpy(a) for a in (qn, kn, vn)), **kw, col_begin=lo,
        col_end=hi, chunk=chunk, ways=k4.split_ways(hq // hkv * sq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("route", ["flash_attention_split_kv",
                                   "flash_attention_tensor_core",
                                   "flash_attention_simt"])
def test_named_routes_refuse_cpu_tensors(route):
    q, k, v = (torch.from_numpy(a) for a in _qkv(12, 1, 2, 2, 4, 8, 8))
    n0 = k4.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        getattr(k4, route)(q, k, v)
    assert k4.launches.value == n0
