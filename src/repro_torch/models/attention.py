"""Attention, the GQA family: MHA/GQA/MQA (+bias, +sliding-window mask),
dense KV cache, cross-attention (port of ``repro.models.attention``).

Layout conventions, the reference's:
  activations x: [B, S, d_model]
  q/k/v heads:   [B, H, S, Dh]
  KV cache:      {"k": [B, Hkv, S_max, Dh], "v": ...}

``cfg.attn_impl`` picks the path exactly as the reference's ``_attend``
does: ``"pallas"`` routes to the K4 op (``kernels.ops.flash_attention``)
only a call with neither ``kv_len`` nor ``q_pos``, which in the reference's
models is the single-token decode step of cross-attention; everything else
runs the plain ``mha_ref``.

State: the reference returns a new cache from ``dynamic_update_slice``.
Here the new K/V rows are written into the given cache tensors in place
(``cache[:, :, pos:pos + S] = ...``) and the same tensors are returned, so
a decode step copies no cache.  ``cache_pos`` is a Python int, so no step
reads a position back from the card.

A sliding-window config decodes through the reference's ring cache: a
window-sized cache whose slot ``p % window`` holds absolute position ``p``,
and ``slot_pos`` (on the device) the position each slot holds (-1:
unwritten), which drives the mask.  The new tokens attend over [old ring ++
themselves], and then the last ``window`` of them are written into the
ring in place, as at most two slice writes whose bounds are host ints.

Not ported yet: MLA (deepseek-v2, raises ``NotImplementedError``; its only
user is a MoE model, ``ROADMAP.md`` Queue A item 9.3); the reference's mesh
branches of ``sharded_attention`` wait for the LM zoo on a mesh (item 9.8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import mha_ref
from repro_torch.models.common import (apply_rope, dense_init, model_dtype,
                                       zeros)

_MLA = ("MLA attention is not ported yet: it comes with its only user, "
        "the MoE LM (ROADMAP.md Queue A item 9.3)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ArchConfig,
              cross: bool = False) -> dict:
    if cfg.mla is not None and not cross:
        raise NotImplementedError(_MLA)
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.head_dim_eff
    dt = model_dtype(cfg)
    p = {
        "wq": dense_init(gen, d, h * dh, dt),
        "wk": dense_init(gen, d, hkv * dh, dt),
        "wv": dense_init(gen, d, hkv * dh, dt),
        "wo": dense_init(gen, h * dh, d, dt),
    }
    if cfg.attn_bias:
        p["bq"] = zeros(gen, (h * dh,), dt)
        p["bk"] = zeros(gen, (hkv * dh,), dt)
        p["bv"] = zeros(gen, (hkv * dh,), dt)
    return p


# ---------------------------------------------------------------------------
# forward — GQA family
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n_heads: int, dh: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, dh).transpose(1, 2)


def _attend(q, k, v, *, causal, window, impl, kv_len=None, q_pos=None,
            kv_pos=None):
    if impl == "pallas" and kv_len is None and q_pos is None:
        from repro_torch.kernels.ops import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window)
    return mha_ref(q, k, v, causal=causal, window=window, kv_len=kv_len,
                   q_pos=q_pos, kv_pos=kv_pos)


def sharded_attention(q, k, v, *, causal, window, impl, q_pos=None,
                      kv_pos=None):
    """Multi-token attention, the reference's no-mesh branch: positions
    default to ``arange``, so masking is positional and the call never
    reaches the kernel (as in the reference)."""
    if q_pos is None:
        q_pos = torch.arange(q.shape[2], dtype=torch.int32, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(k.shape[2], dtype=torch.int32, device=q.device)
    return _attend(q, k, v, causal=causal, window=window, impl=impl,
                   q_pos=q_pos, kv_pos=kv_pos)


def attn_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 kv_cache: Optional[dict] = None,
                 cache_pos: Optional[int] = None,
                 cross_kv: Optional[tuple] = None):
    """Returns (out [B,S,d], kv_cache | None).

    Train/prefill: kv_cache None.  Decode: kv_cache holds [B,Hkv,S_max,Dh];
    the S new tokens are written at ``cache_pos`` (in place) and attention
    runs over the cache with kv_len = cache_pos + S; a ring cache
    (``slot_pos``) takes :func:`_ring_step` instead.
    """
    if cfg.mla is not None and cross_kv is None:
        raise NotImplementedError(_MLA)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_eff
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, h, dh)

    if cross_kv is not None:
        k, v = cross_kv                            # precomputed encoder K/V
        if x.shape[1] > 1:
            out = sharded_attention(q, k, v, causal=False, window=None,
                                    impl=cfg.attn_impl)
        else:
            out = _attend(q, k, v, causal=False, window=None,
                          impl=cfg.attn_impl)
        b, s = x.shape[:2]
        out = out.transpose(1, 2).reshape(b, s, h * dh)
        return out @ p["wo"], None

    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = _split_heads(k, hkv, dh)
    v = _split_heads(v, hkv, dh)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)

    new_cache = None
    kv_len = None
    q_pos = kv_pos = None
    s_new = x.shape[1]
    if kv_cache is not None and "slot_pos" in kv_cache:
        q_pos, kv_pos, k, v = _ring_step(kv_cache, k, v, cache_pos)
        new_cache = kv_cache
    elif kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        ck[:, :, cache_pos:cache_pos + s_new] = k.to(ck.dtype)
        cv[:, :, cache_pos:cache_pos + s_new] = v.to(cv.dtype)
        new_cache = kv_cache
        k, v = ck, cv
        kv_len = cache_pos + s_new
        if s_new > 1:            # cache prefill: positional mask form
            dev = x.device
            q_pos = cache_pos + torch.arange(s_new, dtype=torch.int32,
                                             device=dev)
            idx = torch.arange(k.shape[2], dtype=torch.int32, device=dev)
            kv_pos = torch.where(idx < kv_len, idx, -1)
            kv_len = None

    if kv_cache is None or s_new > 1:
        out = sharded_attention(q, k, v, causal=causal,
                                window=cfg.sliding_window,
                                impl=cfg.attn_impl, q_pos=q_pos, kv_pos=kv_pos)
    else:
        out = _attend(q, k, v, causal=causal, window=cfg.sliding_window,
                      impl=cfg.attn_impl, kv_len=kv_len, q_pos=q_pos,
                      kv_pos=kv_pos)
    b, s = x.shape[:2]
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return out @ p["wo"], new_cache


def _ring_segments(start: int, n: int, size: int) -> list:
    """(slot, offset, length) runs that put positions start..start+n-1
    into slots ``p % size``: at most two, with host-int bounds."""
    out, off = [], 0
    while off < n:
        slot = (start + off) % size
        length = min(n - off, size - slot)
        out.append((slot, off, length))
        off += length
    return out


def _ring_step(cache: dict, k: torch.Tensor, v: torch.Tensor,
               cache_pos: int) -> tuple:
    """The reference's ring branch: the S new tokens attend over [old ring
    contents ++ themselves] (so a multi-token prefill sees its own
    in-window keys that the ring is about to evict), then the last
    ``window`` of them are written into the ring in place.  Returns
    (q_pos, kv_pos, k, v) for the attention."""
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    size, s_new = ck.shape[2], k.shape[2]
    q_pos = torch.arange(cache_pos, cache_pos + s_new, dtype=torch.int32,
                         device=k.device)
    kv_pos = torch.cat([spos, q_pos])
    k_att = torch.cat([ck.to(k.dtype), k], dim=2)
    v_att = torch.cat([cv.to(v.dtype), v], dim=2)
    skip = max(s_new - size, 0)              # only the last `size` are kept
    for slot, off, n in _ring_segments(cache_pos + skip, s_new - skip, size):
        src = slice(skip + off, skip + off + n)
        ck[:, :, slot:slot + n] = k[:, :, src].to(ck.dtype)
        cv[:, :, slot:slot + n] = v[:, :, src].to(cv.dtype)
        spos[slot:slot + n] = q_pos[src]
    return q_pos, kv_pos, k_att, v_att


def make_cross_kv(p: dict, cfg: ArchConfig, enc_out: torch.Tensor):
    """Encoder K/V for the decoder's cross-attention."""
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_eff
    k = _split_heads(enc_out @ p["wk"], hkv, dh)
    v = _split_heads(enc_out @ p["wv"], hkv, dh)
    return k, v


def cache_dtype(cfg: ArchConfig) -> torch.dtype:
    return model_dtype(cfg)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                  device) -> dict:
    """Zero K/V of ``max_len`` rows; a sliding-window config's cache is the
    ring (module docstring), with ``slot_pos`` all -1."""
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_eff
    shape = (batch, hkv, max_len, dh)
    cache = {"k": torch.zeros(shape, dtype=cache_dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=cache_dtype(cfg), device=device)}
    if cfg.sliding_window is not None:
        cache["slot_pos"] = torch.full((max_len,), -1, dtype=torch.int32,
                                       device=device)
    return cache
