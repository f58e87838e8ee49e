"""Attention: MHA/GQA/MQA (+bias, +sliding-window mask), dense KV cache,
cross-attention, and MLA (deepseek-v2) with its compressed cache (port of
``repro.models.attention``).

Layout conventions, the reference's:
  activations x: [B, S, d_model]
  q/k/v heads:   [B, H, S, Dh]
  KV cache:      {"k": [B, Hkv, S_max, Dh], "v": ...}; MLA caches the
                 compressed {"c_kv": [B, S_max, kv_lora], "k_rope":
                 [B, S_max, qk_rope]} (576 values a token a layer at
                 deepseek's width, whatever the head count)

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

MLA runs the reference's three branches: the expand form (per-head K/V
from the latent) in training and in a multi-token prefill over the written
cache, and the absorbed form (attention in the latent space, f32) in a
single-token decode step.  The MLA cache is written in place too.

Not ported yet: the reference's mesh branches of ``sharded_attention``
wait for the LM zoo on a mesh (``ROADMAP.md`` Queue A item 9.8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import mha_ref
from repro_torch.models.common import (apply_rope, dense_init, model_dtype,
                                       rms_norm, zeros)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ArchConfig,
              cross: bool = False) -> dict:
    if cfg.mla is not None and not cross:
        return _init_mla(gen, cfg)
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


def _init_mla(gen: torch.Generator, cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dt = model_dtype(cfg)
    return {
        "q_down": dense_init(gen, d, m.q_lora, dt),
        "q_norm": zeros(gen, (m.q_lora,)),
        "q_up": dense_init(gen, m.q_lora, h * (m.qk_nope + m.qk_rope), dt),
        "kv_down": dense_init(gen, d, m.kv_lora + m.qk_rope, dt),
        "kv_norm": zeros(gen, (m.kv_lora,)),
        "k_up": dense_init(gen, m.kv_lora, h * m.qk_nope, dt),
        "v_up": dense_init(gen, m.kv_lora, h * m.v_head, dt),
        "wo": dense_init(gen, h * m.v_head, d, dt),
    }


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
        return mla_forward(p, cfg, x, positions, causal=causal,
                           kv_cache=kv_cache, cache_pos=cache_pos)
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


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

def mla_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                kv_cache: Optional[dict] = None,
                cache_pos: Optional[int] = None):
    """Returns (out [B,S,d], kv_cache | None).  With a cache, the S new
    tokens' ``c_kv`` and ``k_rope`` are written at ``cache_pos`` in place;
    a single token then attends in the absorbed form, a prompt in the
    expand form over the cache (positional mask, unwritten rows -1)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    dev = x.device

    ql = rms_norm(x @ p["q_down"], p["q_norm"])
    q = (ql @ p["q_up"]).reshape(b, s, h, m.qk_nope + m.qk_rope).transpose(
        1, 2)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)

    kvd = x @ p["kv_down"]
    c_kv = rms_norm(kvd[..., :m.kv_lora], p["kv_norm"])       # [B,S,kv_lora]
    k_rope = apply_rope(kvd[..., None, m.kv_lora:].transpose(1, 2),
                        positions[:, None, :], cfg.rope_theta)  # [B,1,S,rope]

    if kv_cache is not None:
        c_all, r_all = kv_cache["c_kv"], kv_cache["k_rope"]
        c_all[:, cache_pos:cache_pos + s] = c_kv.to(c_all.dtype)
        r_all[:, cache_pos:cache_pos + s] = k_rope[:, 0].to(r_all.dtype)
        kv_len = cache_pos + s
        if s == 1:
            # single-token decode: absorbed projections, attention in the
            # compressed c_kv space
            return _mla_absorbed_attend(p, cfg, q_nope, q_rope, c_all, r_all,
                                        kv_len, b, s), kv_cache
        # multi-token prefill: the expand form over the written cache
        q_pos = cache_pos + torch.arange(s, dtype=torch.int32, device=dev)
        sk = c_all.shape[1]
        idx = torch.arange(sk, dtype=torch.int32, device=dev)
        kv_pos = torch.where(idx < kv_len, idx, -1)
        c_src, r_src, s_kv = c_all, r_all[:, None], sk
    else:
        q_pos = kv_pos = None
        c_src, r_src, s_kv = c_kv, k_rope, s

    # train / prefill: per-head keys and values expanded from the latent
    k_nope = (c_src @ p["k_up"]).reshape(b, s_kv, h, m.qk_nope).transpose(
        1, 2)
    v = (c_src @ p["v_up"]).reshape(b, s_kv, h, m.v_head).transpose(1, 2)
    k = torch.cat([k_nope, r_src.to(k_nope.dtype).expand(
        b, h, s_kv, m.qk_rope)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.qk_nope + m.qk_rope) ** -0.5
    out = _mla_attend(qf, k, v, scale, causal, q_pos, kv_pos)
    out = out.transpose(1, 2).reshape(b, s, h * m.v_head)
    return out @ p["wo"], kv_cache


def _mla_attend(qf, k, v, scale, causal, q_pos, kv_pos):
    """The expand form: the scale folded into q (``mha_ref`` rescales by
    dh^-1/2, dh = qk_nope + qk_rope, while V's head is v_head), then the
    shared multi-token wrapper."""
    dh = qf.shape[-1]
    qs = qf * (scale * dh ** 0.5)
    return sharded_attention(qs, k, v, causal=causal, window=None,
                             impl="reference", q_pos=q_pos, kv_pos=kv_pos)


def _mla_absorbed_attend(p, cfg, q_nope, q_rope, c_all, r_all, kv_len, b, s):
    """Decode with absorbed projections, in f32: k_up folded into q
    (q_c = q_nope · W_kup, [B,H,S,kv_lora]), v_up applied to the context
    per head; the mask (-1e30) covers the whole [S_max] cache."""
    m = cfg.mla
    h = cfg.num_heads
    w_kup = p["k_up"].reshape(m.kv_lora, h, m.qk_nope).float()
    q_c = torch.einsum("bhsn,lhn->bhsl", q_nope.float(), w_kup)
    c32 = c_all.float()
    s_kv = c_all.shape[1]
    logits = torch.einsum("bhsl,btl->bhst", q_c, c32)
    logits = logits + torch.einsum("bhsr,btr->bhst", q_rope.float(),
                                   r_all.float())
    logits = logits * (m.qk_nope + m.qk_rope) ** -0.5
    dev = c_all.device
    t_idx = torch.arange(s_kv, device=dev)[None, None, None, :]
    q_idx = (kv_len - s) + torch.arange(s, device=dev)[None, None, :, None]
    logits = torch.where(t_idx <= q_idx, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhst,btl->bhsl", probs, c32)
    w_vup = p["v_up"].reshape(m.kv_lora, h, m.v_head).float()
    out = torch.einsum("bhsl,lhv->bhsv", ctx, w_vup)
    out = out.transpose(1, 2).reshape(b, s, h * m.v_head).to(q_nope.dtype)
    return out @ p["wo"]


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                   device) -> dict:
    """Zero compressed cache of ``max_len`` rows: ``c_kv`` [B, S, kv_lora]
    and the shared ``k_rope`` [B, S, qk_rope]."""
    m = cfg.mla
    dt = cache_dtype(cfg)
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora), dtype=dt,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope), dtype=dt,
                                  device=device)}
