"""K4: blocked attention with an online softmax (FlashAttention forward).

Counterpart of the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.  Semantics,
the Pallas kernel's: query row i sits at absolute position ``i +
q_offset``; key j is visible when ``j < kv_len``, and ``j <= i + q_offset``
when causal, and ``j > i + q_offset - window`` when a window is set; a row
that sees no key is 0.  GQA: the kv head of q head h is ``h // (Hq /
Hkv)``.

* :func:`flash_attention_plain` — the plain PyTorch version:
  :func:`~repro_torch.kernels.ref.mha_ref` with those positions (full
  softmax in f32).  The CPU path and the tests use it, and the card's
  parity check holds the kernel to it.
* :func:`flash_attention_cuda` — the wrapper: checks its operands,
  allocates the output, picks one of three CUDA routes by
  :func:`k4_route`, launches it on the current stream and counts the call
  in :data:`launches` and in the route's own counter in
  :data:`route_calls`.  It never falls back to the plain version.
* The routes, each a kernel whose source header says what bounds it on an
  H100 and how its design answers that, and each callable by name:

  - :func:`flash_attention_split_kv` (``csrc/flash_attention_split.cu``),
    for at most :data:`SPLIT_KV_MAX_ROWS` rows per (batch, kv head), any
    dtype: the keys are cut into chunks over a grid that fills the card,
    each block writes partial (m, l, acc) per row to f32 scratch, and a
    second launch combines them (:func:`split_plan` sizes the chunks;
    :func:`flash_attention_split_kv_plain` is the same algebra in plain
    PyTorch, pass by pass);
  - :func:`flash_attention_tensor_core` (``csrc/flash_attention_tc.cu``),
    bf16 with more rows: FlashAttention-2 with ``mma.sync`` on the tensor
    cores;
  - :func:`flash_attention_simt` (``csrc/flash_attention.cu``), float32
    with more rows: the products on the CUDA cores in f32 (the tensor cores
    would round f32 to TF32).

None has a backward: the reference has none (``jax.grad`` through the
Pallas call raises), and ``ops.flash_attention`` refuses a gradient.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels._ext import LaunchCounter, load_kernels
from repro_torch.kernels.ref import mha_ref

ATTN_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
ROUTES = ("split_kv", "tensor_core", "simt")
SPLIT_KV_MAX_ROWS = 16          # rows per (batch, kv head): G * Sq
SPLIT_TILE = 32                 # keys per warp tile of the split-KV kernel
SPLIT_SMEM_BYTES = 80 * 1024    # K and V of one chunk: two blocks per SM
H100_SMS = 132
_NEG = -1e30                    # the Pallas kernel's masked score

launches = LaunchCounter()      # calls that launched K4, whatever the route
route_calls = {route: LaunchCounter() for route in ROUTES}


def k4_route(rows: int, dtype: torch.dtype) -> str:
    """The route of a call with ``rows = G * Sq`` query rows per (batch, kv
    head): split-KV for few rows (every decode call), else the tensor cores
    for bf16 and the CUDA cores for float32."""
    if rows <= SPLIT_KV_MAX_ROWS:
        return "split_kv"
    return "tensor_core" if dtype == torch.bfloat16 else "simt"


def split_ways(rows: int) -> int:
    """Warps of a split-KV block (8 warps) that share one group of up to 4
    rows, each taking every ``ways``-th 32-key tile of the chunk."""
    return 8 if rows <= 4 else 4 if rows <= 8 else 2


def visible_keys(sq: int, sk: int, *, causal: bool, window: Optional[int],
                 kv_len: int, q_offset: int) -> tuple[int, int]:
    """[col_begin, col_end): the keys that some query row can see."""
    col_end = min(kv_len, sk)
    if causal:
        col_end = min(col_end, q_offset + sq)
    col_begin = max(0, q_offset - window + 1) if window is not None else 0
    return col_begin, max(col_end, col_begin)


def split_plan(blocks: int, dh: int, elt: int, n_keys: int,
               sms: int = H100_SMS) -> tuple[int, int]:
    """(chunk, splits) for ``blocks = B * Hkv``: chunks of a multiple of 32
    keys whose K and V fit ``SPLIT_SMEM_BYTES`` (rows padded as in the
    kernel), about two blocks of 8 warps per SM: ``splits`` is
    ``ceil(2 * sms / blocks)`` rounded down to a power of two, or more where
    a chunk would not fit."""
    tiles = max(-(-n_keys // SPLIT_TILE), 1)
    pitch = -(-dh * elt // 128) * 128 + 16
    max_tiles = max(SPLIT_SMEM_BYTES // (2 * pitch * SPLIT_TILE), 1)
    want = 1 << (-(-2 * sms // max(blocks, 1))).bit_length() - 1
    splits = min(max(want, -(-tiles // max_tiles)), tiles)
    per = -(-tiles // splits)
    return SPLIT_TILE * per, -(-tiles // per)


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


def _merge(ms, ls, accs):
    """(M, L, ACC) of partials (m_p, l_p, acc_p) stacked on dim 0: M = max
    m_p, L = sum exp(m_p - M) l_p, ACC = sum exp(m_p - M) acc_p.  A partial
    that saw no key (m = -1e30, l = 0, acc = 0) adds nothing."""
    m = torch.stack(ms)
    big = m.amax(0)
    wts = torch.exp(m - big)
    return big, (wts * torch.stack(ls)).sum(0), (wts * torch.stack(accs)).sum(0)


def split_kv_partials_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None,
        scale: Optional[float] = None, kv_len: Optional[int] = None,
        q_offset: Optional[int] = None, col_begin: int = 0,
        col_end: Optional[int] = None, chunk: int = SPLIT_TILE,
        ways: int = 1) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 of route (i) in plain PyTorch, f32: keys [col_begin, col_end)
    cut into chunks of ``chunk``.  In each chunk, warp ``w`` of ``ways``
    takes the 32-key tiles ``t % ways == w`` and holds, per row, ``m`` (the
    largest visible score, -1e30 if none), ``l = sum exp(s - m)`` and
    ``acc = sum exp(s - m) v`` over its visible keys (l = 0, acc = 0 if
    none); the chunk's warps are then merged (:func:`_merge`) into the
    split's partial.  -> (m, l, acc), [splits, B, Hkv, G, Sq, 1] twice and
    [splits, B, Hkv, G, Sq, Dh]."""
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    col_end = sk if col_end is None else col_end
    qf = (q.float() * scale).reshape(b, hkv, hq // hkv, sq, dh)
    s = torch.einsum("bngqd,bnkd->bngqk", qf, k.float())
    pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    cols = torch.arange(sk, device=q.device)[None, :]
    vis = (cols < min(kv_len, sk)) & (cols >= col_begin) & (cols < col_end)
    if causal:
        vis = vis & (cols <= pos)
    if window is not None:
        vis = vis & (cols > pos - window)
    parts = []
    for split in range(max(-(-(col_end - col_begin) // chunk), 1)):
        c_lo = col_begin + split * chunk
        tile = (cols - c_lo) // SPLIT_TILE
        ms, ls, accs = [], [], []
        for w in range(ways):
            own = vis & (cols >= c_lo) & (cols < c_lo + chunk) & (
                tile % ways == w)
            m = torch.where(own, s, _NEG).amax(-1, keepdim=True)
            p = torch.where(own, torch.exp(s - m), 0.0)
            ms.append(m)
            ls.append(p.sum(-1, keepdim=True))
            accs.append(torch.einsum("bngqk,bnkd->bngqd", p, v.float()))
        parts.append(_merge(ms, ls, accs))
    return tuple(torch.stack(t) for t in zip(*parts))


def split_kv_combine_plain(m: torch.Tensor, l: torch.Tensor,
                           acc: torch.Tensor) -> torch.Tensor:
    """Pass 2 of route (i): the splits merged (:func:`_merge`), ``ACC /
    max(L, 1e-30)``: a split that saw no key enters with weight 0, and a row
    that no split saw is 0."""
    _, big_l, big_acc = _merge(list(m), list(l), list(acc))
    return big_acc / big_l.clamp_min(1e-30)


def flash_attention_split_kv_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, **kw) -> torch.Tensor:
    """Route (i)'s algebra in plain PyTorch: :func:`split_kv_partials_plain`
    (same keywords) then :func:`split_kv_combine_plain` -> q's shape and
    dtype."""
    out = split_kv_combine_plain(*split_kv_partials_plain(q, k, v, **kw))
    return out.reshape(q.shape).to(q.dtype)


def _check(q, k, v, causal, window, scale, kv_len, q_offset):
    """Operand checks of every CUDA route; -> (scale, kv_len, q_offset)."""
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
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernels copy 16-byte pieces)")
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
    return scale, kv_len, q_offset


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(route, q, k, v, out, scale, causal, window, kv_len, q_offset):
    args = (float(scale), bool(causal), -1 if window is None else int(window),
            kv_len, q_offset)
    if route != "split_kv":
        kernel = {"tensor_core": "flash_attention_tc",
                  "simt": "flash_attention"}[route]
        getattr(load_kernels(), kernel)(q, k, v, out, *args)
        return
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rows = hq // hkv * sq
    col_begin, col_end = visible_keys(sq, sk, causal=causal, window=window,
                                      kv_len=kv_len, q_offset=q_offset)
    chunk, splits = split_plan(b * hkv, dh, q.element_size(),
                               col_end - col_begin,
                               _sm_count(q.device.index or 0))
    part_acc = torch.empty((b, hkv, splits, rows, dh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hkv, splits, rows, 2), dtype=torch.float32,
                          device=q.device)
    load_kernels().flash_attention_split(
        q, k, v, out, part_acc, part_ml, *args, col_begin, col_end, chunk,
        splits, split_ways(rows))


def _run(route, q, k, v, causal, window, scale, kv_len, q_offset):
    """Check, allocate, launch ``route`` (None: the one :func:`k4_route`
    picks) and count the call."""
    scale, kv_len, q_offset = _check(q, k, v, causal, window, scale, kv_len,
                                     q_offset)
    rows = q.shape[1] // k.shape[1] * q.shape[2]
    route = route or k4_route(rows, q.dtype)
    if route == "split_kv" and rows > SPLIT_KV_MAX_ROWS:
        raise ValueError(f"the split-KV route takes at most "
                         f"{SPLIT_KV_MAX_ROWS} rows per (batch, kv head), "
                         f"got G * Sq = {rows}")
    if route == "tensor_core" and q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core route takes bfloat16, got "
                        f"{q.dtype}")
    out = torch.empty_like(q)
    if out.numel():                  # an empty grid is not a valid launch
        _launch(route, q, k, v, out, scale, causal, window, kv_len, q_offset)
        launches.add()
        route_calls[route].add()
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None,
                         q_offset: Optional[int] = None) -> torch.Tensor:
    """Launch K4 on the route :func:`k4_route` picks.  q [B, Hq, Sq, Dh],
    k/v [B, Hkv, Sk, Dh], all float32 or all bfloat16, contiguous and
    16-byte aligned on one CUDA device; Hq % Hkv == 0; Dh a multiple of 8
    up to 256 -> q's shape and dtype."""
    return _run(None, q, k, v, causal, window, scale, kv_len, q_offset)


def flash_attention_split_kv(q, k, v, *, causal=True, window=None,
                             scale=None, kv_len=None, q_offset=None):
    """Route (i) by name: split-KV, at most 16 rows per (batch, kv head)."""
    return _run("split_kv", q, k, v, causal, window, scale, kv_len, q_offset)


def flash_attention_tensor_core(q, k, v, *, causal=True, window=None,
                                scale=None, kv_len=None, q_offset=None):
    """Route (ii) by name: FlashAttention-2 on the tensor cores, bf16."""
    return _run("tensor_core", q, k, v, causal, window, scale, kv_len,
                q_offset)


def flash_attention_simt(q, k, v, *, causal=True, window=None, scale=None,
                         kv_len=None, q_offset=None):
    """Route (iii) by name: the CUDA-core kernel, any dtype and rows."""
    return _run("simt", q, k, v, causal, window, scale, kv_len, q_offset)
