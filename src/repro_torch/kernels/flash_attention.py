"""K4: blocked attention with an online softmax (FlashAttention forward).

Counterpart of the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``; the CUDA
kernel is ``repro_torch/csrc/flash_attention.cu``, whose header says what
bounds it on an H100 and how its design answers that.  Semantics, the
Pallas kernel's: query row i sits at absolute position ``i + q_offset``;
key j is visible when ``j < kv_len``, and ``j <= i + q_offset`` when
causal, and ``j > i + q_offset - window`` when a window is set; a row that
sees no key is 0.  GQA: the kv head of q head h is ``h // (Hq / Hkv)``.

* :func:`flash_attention_plain` — the plain PyTorch version:
  :func:`~repro_torch.kernels.ref.mha_ref` with those positions (full
  softmax in f32).  The CPU path and the tests use it, and the card's
  parity check holds the kernel to it.
* :func:`flash_attention_cuda` — the wrapper: checks its operands,
  allocates the output, launches the kernel on the current stream and
  counts the launch in :data:`launches`.  It never falls back to the plain
  version.

Neither has a backward: the reference has none (``jax.grad`` through the
Pallas call raises), and ``ops.flash_attention`` refuses a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._ext import LaunchCounter, load_kernels
from repro_torch.kernels.ref import mha_ref

launches = LaunchCounter()

ATTN_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _defaults(q, k, scale, kv_len, q_offset):
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
    kv_len = sk if kv_len is None else int(kv_len)
    q_offset = kv_len - sq if q_offset is None else int(q_offset)
    return (dh ** -0.5 if scale is None else scale), kv_len, q_offset


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          kv_len: Optional[int] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """q [B, Hq, Sq, Dh], k/v [B, Hkv, Sk, Dh] -> q's shape and dtype.
    ``kv_len`` defaults to Sk, ``q_offset`` to ``kv_len - Sq`` (the Pallas
    kernel's defaults)."""
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    q_pos = torch.arange(q.shape[2], device=q.device) + q_offset
    cols = torch.arange(k.shape[2], device=q.device)
    kv_pos = torch.where(cols < kv_len, cols, -1)
    return mha_ref(q, k, v, causal=causal, window=window, scale=scale,
                   q_pos=q_pos, kv_pos=kv_pos)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None,
                         q_offset: Optional[int] = None) -> torch.Tensor:
    """Launch K4.  q [B, Hq, Sq, Dh], k/v [B, Hkv, Sk, Dh], all float32 or
    all bfloat16, contiguous on one CUDA device; Hq % Hkv == 0; Dh a
    multiple of 8 up to 256 -> q's shape and dtype."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype not in ATTN_DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; q, k and v must "
                            f"share one of {ATTN_DTYPES}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, hq, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit [B,Hq,Sq,Dh] / "
                         f"[B,Hkv,Sk,Dh]")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if dh % 8 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} unsupported: K4 takes a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    if not 0 <= kv_len <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[2]}]")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    out = torch.empty_like(q)
    if out.numel():                  # an empty grid is not a valid launch
        load_kernels().flash_attention(
            q, k, v, out, float(scale), bool(causal),
            -1 if window is None else int(window), kv_len, q_offset)
        launches.add()
    return out
