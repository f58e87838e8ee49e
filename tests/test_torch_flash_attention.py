"""K4's CPU side against the reference: the port's ``mha_ref``,
``flash_attention_plain`` (the kernel's plain version, with explicit
``kv_len`` / ``q_offset``) and ``ops.flash_attention`` (the plain version
on CPU tensors) against ``repro.kernels.ref.mha_ref``,
``flash_attention_pallas`` (``interpret=True``) and
``repro.kernels.ops.flash_attention``, on the same numpy inputs.

The cases are the JAX kernel tests' (``tests/test_kernels.py``): MHA, GQA,
MQA in f32 and bf16, a sliding window, cross-attention, one-token decode,
a poisoned tail past ``kv_len`` and odd lengths.  Tolerances are theirs:
2e-5 in f32 (3e-5 for the odd lengths), 3e-2 in bf16 (the two frameworks
round bf16 at other places).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# (name, b, hq, hkv, sq, sk, dh, causal, window, pallas block)
CASES = [
    ("mha", 1, 2, 2, 64, 64, 32, True, None, 16),
    ("gqa", 2, 4, 2, 128, 128, 64, True, None, 32),
    ("mqa", 1, 8, 1, 64, 64, 64, True, None, 16),
    ("window", 1, 2, 2, 128, 128, 32, True, 32, 32),
    ("cross", 2, 2, 2, 32, 96, 32, False, None, 16),
    ("decode", 1, 4, 2, 1, 256, 64, True, None, 16),
    ("odd", 1, 2, 1, 37, 53, 32, True, None, 16),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _tol(name, dtype):
    if dtype == "bf16":
        return 3e-2
    return 3e-5 if name == "odd" else 2e-5


def _qkv(seed, b, hq, hkv, sq, sk, dh, dtype):
    """The same f32 numpy draws for both packages, each cast to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, dh)).astype(np.float32)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]
    _, jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mha_ref_matches_reference(case, dtype):
    name, b, hq, hkv, sq, sk, dh, causal, window, _ = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, b, hq, hkv, sq, sk, dh, dtype)
    want = jref.mha_ref(jq, jk, jv, causal=causal, window=window)
    got = ref.mha_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, _tol(name, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ops_flash_attention_matches_reference_op(case, dtype):
    """The op on CPU tensors (the plain version, end-aligned queries)
    against the reference op (Pallas in interpret mode after padding)."""
    name, b, hq, hkv, sq, sk, dh, causal, window, blk = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, b, hq, hkv, sq, sk, dh, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=blk, block_k=blk)
    n0 = k4.launches.value
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert k4.launches.value == n0          # a CPU tensor launches nothing
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, _tol(name, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "odd"],
                         ids=[c[0] for c in CASES if c[0] != "odd"])
def test_plain_version_matches_pallas_kernel(case, dtype):
    """The kernel's plain version against the Pallas kernel itself
    (interpret mode), both given the same kv_len and q_offset."""
    name, b, hq, hkv, sq, sk, dh, causal, window, blk = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, b, hq, hkv, sq, sk, dh, dtype)
    bq = max(16, min(blk, sq))
    pad = (-sq) % bq
    jq_p = jnp.pad(jq, ((0, 0), (0, 0), (0, pad), (0, 0)))
    want = flash_attention_pallas(jq_p, jk, jv, causal=causal, window=window,
                                  block_q=bq, block_k=blk, kv_len=sk,
                                  q_offset=sk - sq, interpret=True)[:, :, :sq]
    got = k4.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   kv_len=sk, q_offset=sk - sq)
    _close(got, want, _tol(name, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_len_masks_a_poisoned_tail(dtype):
    """Keys past kv_len are invisible: a tail of 1e5 changes nothing
    (the JAX test's case: 32 queries at q_offset 16 over 48 of 64 keys)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(4, 1, 2, 2, 32, 64, 32, dtype)
    jk, jv = jk.at[:, :, 48:].set(1e5), jv.at[:, :, 48:].set(1e5)
    tk[:, :, 48:] = 1e5
    tv[:, :, 48:] = 1e5
    want = flash_attention_pallas(jq, jk, jv, causal=False, kv_len=48,
                                  q_offset=16, block_q=16, block_k=16,
                                  interpret=True)
    got = k4.flash_attention_plain(tq, tk, tv, causal=False, kv_len=48,
                                   q_offset=16)
    _close(got, want, _tol("poison", dtype))
    clean = ref.mha_ref(tq, tk[:, :, :48], tv[:, :, :48], causal=False)
    _close(got, clean.numpy() if dtype == "f32" else clean.float().numpy(),
           _tol("poison", dtype))


def test_q_offset_and_window_with_padded_queries():
    """A q_offset that is not kv_len - Sq (queries end-padded, as the
    reference's op pads them) with a causal window: rows by position."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, 2, 4, 2, 32, 80, 16, "f32")
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=24,
                                  kv_len=70, q_offset=40, block_q=16,
                                  block_k=16, interpret=True)
    got = k4.flash_attention_plain(tq, tk, tv, causal=True, window=24,
                                   kv_len=70, q_offset=40)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 3)])
def test_mha_ref_positional_masks(causal, window):
    """q_pos / kv_pos (ring-cache form): slots in no position order, kv_pos
    < 0 unwritten; query rows that see no key come out as 0 in both."""
    rng = np.random.default_rng(6)
    (jq, jk, jv), (tq, tk, tv) = _qkv(6, 2, 4, 2, 6, 12, 16, "f32")
    kv_pos = rng.permutation(np.arange(-3, 9)).astype(np.int32)
    q_pos = np.array([-2, 0, 3, 5, 8, 11], np.int32)
    want = jref.mha_ref(jq, jk, jv, causal=causal, window=window,
                        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos))
    got = ref.mha_ref(tq, tk, tv, causal=causal, window=window,
                      q_pos=torch.from_numpy(q_pos),
                      kv_pos=torch.from_numpy(kv_pos))
    _close(got, want, 2e-5)
    if causal:
        assert torch.count_nonzero(got[:, :, 0]) == 0     # position -2


@pytest.mark.parametrize("kv_len", [1, 7, 12])
def test_mha_ref_kv_len_end_alignment(kv_len):
    (jq, jk, jv), (tq, tk, tv) = _qkv(7, 1, 2, 1, 3, 12, 8, "f32")
    want = jref.mha_ref(jq, jk, jv, causal=True, kv_len=kv_len)
    got = ref.mha_ref(tq, tk, tv, causal=True, kv_len=kv_len)
    _close(got, want, 2e-5)


def test_flash_attention_refuses_a_gradient():
    """The reference has no VJP for K4; the op raises under grad."""
    _, (tq, tk, tv) = _qkv(8, 1, 2, 2, 4, 8, 8, "f32")
    tq.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.flash_attention(tq, tk, tv, causal=False)
    with torch.no_grad():
        assert ops.flash_attention(tq, tk, tv).shape == tq.shape


def test_cuda_wrapper_refuses_cpu_tensors():
    _, (tq, tk, tv) = _qkv(9, 1, 2, 2, 4, 8, 8, "f32")
    with pytest.raises(ValueError, match="CUDA"):
        k4.flash_attention_cuda(tq, tk, tv)
