"""Shared helpers of the ``test_torch_*`` parity tests (port vs reference).

Inputs are made with numpy from fixed seeds and handed to both packages;
results come back as numpy arrays.  Nothing here changes process-wide
state.
"""
from __future__ import annotations

import numpy as np
import pytest


def requires_cuda():
    """Skip the calling test unless a CUDA card is present.  Called inside
    the test (never at import), so every pytest worker collects the same
    tests."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs under `python3 chip_smoke.py` "
                    "and `pytest -m gpu` on the GPU host)")
    return torch.device("cuda")


def jax_params_to_numpy(params) -> dict:
    """The reference's ``{"layers": [{"w", "b"}]}`` as numpy arrays."""
    return {"layers": [{"w": np.asarray(layer["w"]), "b": np.asarray(layer["b"])}
                       for layer in params["layers"]]}


def assert_batches_equal(mb_ref, mb_port) -> None:
    """Two MiniBatches (reference, port) hold the same host arrays."""
    dr, dp = mb_ref.device, mb_port.device
    assert len(dr.blocks) == len(dp.blocks)
    for br, bp in zip(dr.blocks, dp.blocks):
        np.testing.assert_array_equal(br.nbr_idx, bp.nbr_idx)
        np.testing.assert_array_equal(br.nbr_w, bp.nbr_w)
        np.testing.assert_array_equal(br.dst_mask, bp.dst_mask)
        assert (br.num_src, br.num_dst) == (bp.num_src, bp.num_dst)
    for name in ("input_cache_slots", "input_streamed", "input_mask",
                 "labels", "label_mask"):
        np.testing.assert_array_equal(getattr(dr, name), getattr(dp, name))
    np.testing.assert_array_equal(mb_ref.input_node_ids, mb_port.input_node_ids)
    assert (mb_ref.num_input, mb_ref.num_cached, mb_ref.bytes_streamed,
            mb_ref.num_isolated) == (mb_port.num_input, mb_port.num_cached,
                                     mb_port.bytes_streamed,
                                     mb_port.num_isolated)
    assert mb_ref.cache_version == mb_port.cache_version


def lookup_case(seed, c, s0, d, b, k, exact, miss_frac=0.5):
    """numpy inputs of K1: a [c, d] cache, [s0, d] streamed rows (zero where
    cached), slots, [b, k] lane indices and weights; integer-valued when
    ``exact``."""
    rng = np.random.default_rng(seed)
    if exact:
        cache = rng.integers(-128, 129, (c, d)).astype(np.float32)
        streamed = rng.integers(-128, 129, (s0, d)).astype(np.float32)
        w = rng.integers(-8, 9, (b, k)).astype(np.float32)
    else:
        cache = rng.normal(size=(c, d)).astype(np.float32)
        streamed = rng.normal(size=(s0, d)).astype(np.float32)
        w = rng.normal(size=(b, k)).astype(np.float32)
    slots = np.full(s0, -1, np.int32)
    n_hit = min(c, int(s0 * (1 - miss_frac)))
    slots[rng.choice(s0, n_hit, replace=False)] = rng.permutation(c)[:n_hit]
    idx = rng.integers(0, s0, (b, k)).astype(np.int32)
    streamed[slots >= 0] = 0.0        # as the store assembles them
    return cache, streamed, slots, idx, w


def ladies_case(seed, s0, d, b, k, exact, live_frac=0.25, isolated=0.05):
    """numpy inputs of K1 on LADIES's layer 0 with no feature store: a
    1-row zero cache, every slot -1 (all lanes miss), [s0, d] streamed
    rows, and [b, k] lanes of which each row's first few are live (about
    ``live_frac`` of them, none on about ``isolated`` of the rows); masked
    lanes hold idx 0 and w 0, as ``make_block`` pads them.  Live weights
    are integer-valued when ``exact``, else each row's sum to 1 (the LADIES
    row normalisation)."""
    rng = np.random.default_rng(seed)
    cache = np.zeros((1, d), np.float32)
    if exact:
        streamed = rng.integers(-128, 129, (s0, d)).astype(np.float32)
        w = rng.integers(-8, 9, (b, k)).astype(np.float32)
    else:
        streamed = rng.normal(size=(s0, d)).astype(np.float32)
        w = rng.random((b, k)).astype(np.float32)
    slots = np.full(s0, -1, np.int32)
    n_live = rng.binomial(k, live_frac, b)
    n_live[rng.random(b) < isolated] = 0
    live = np.arange(k)[None, :] < n_live[:, None]
    idx = np.where(live, rng.integers(0, s0, (b, k)), 0).astype(np.int32)
    w = np.where(live, w, 0.0).astype(np.float32)
    if not exact:
        w = (w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)).astype(
            np.float32)
    return cache, streamed, slots, idx, w


def gather_case(seed, n, d, b, k, exact):
    """numpy inputs of K2: an [n, d] table, [b, k] indices and weights;
    integer-valued when ``exact``."""
    rng = np.random.default_rng(seed)
    if exact:
        feat = rng.integers(-128, 129, (n, d)).astype(np.float32)
        w = rng.integers(-8, 9, (b, k)).astype(np.float32)
    else:
        feat = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=(b, k)).astype(np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    return feat, idx, w


def adj_case(seed, rows, max_nc):
    """numpy arrays of a random device CSR over ``rows`` table rows: up to
    ``max_nc`` cached neighbors per row, degrees, hit probabilities (one
    row below the 1e-6 clamp); ``indices`` padded to a power of two of at
    least 1024, as the store pads it.  Returns (indptr, indices, deg,
    hitp)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_nc + 1, rows)
    indptr = np.zeros(rows + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    indices = np.zeros(1 << (max(1024, int(indptr[-1])) - 1).bit_length(),
                       np.int32)
    indices[:indptr[-1]] = rng.integers(0, rows, int(indptr[-1]))
    deg = rng.integers(0, 40, rows).astype(np.float32)
    hitp = rng.random(rows).astype(np.float32)
    hitp[rows // 2] = 1e-9
    return indptr, indices, deg, hitp


def sample_case(seed, rows, b, k, uncached=0.3):
    """numpy layer-0 operands of K3 over a ``rows``-row table: dst_rows [b]
    (-1 for about ``uncached`` of them), fallback lanes and weights [b, k]
    (set only on uncached rows, some lanes dead) and a uint32 [1, 2] key."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, rows, b).astype(np.int32)
    dst[rng.random(b) < uncached] = -1
    fb_rows = np.full((b, k), -1, np.int32)
    fb_w = np.zeros((b, k), np.float32)
    miss = dst < 0
    lanes = rng.integers(-1, rows, (int(miss.sum()), k)).astype(np.int32)
    fb_rows[miss] = lanes
    fb_w[miss] = np.where(lanes >= 0, rng.random(lanes.shape), 0.0)
    key = rng.integers(0, 2 ** 32, size=(1, 2), dtype=np.uint32)
    return dst, fb_rows, fb_w, key
