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

On a mesh whose ``model`` axis is larger than 1, the projections follow
the rule table: ``wq``/``wk``/``wv`` (and their
biases) hold column blocks and ``wo`` the matching row block wherever the
flat width divides the axis, and the partial outputs of ``wo`` are summed
over the model group.  The reference's ``sharded_attention`` then lets
``shard_map`` pick heads or sequence parallelism; here only its maths is
kept (:func:`_attn_tp`): q stays head-local wherever the head count
divides the axis, and K/V are either head-local too or gathered whole
(gemma's single KV head), each rank then taking the KV head of each of
its q heads; with a head count that does not divide, q, K and V are
gathered and every rank attends over all heads, keeping its block of the
output for ``wo``.  MLA runs head-local where its heads divide the axis
(``q_up``/``k_up``/``v_up`` column blocks, ``wo`` a row block,
``q_down``/``kv_down`` replicated); where they do not (deepseek's 128
heads on 3 ranks), every rank attends over all heads and each projection
follows its leaf's layout (:func:`_mla_up`): a column block, not aligned
to heads (``q_up``: 8,192 of 24,576 columns), is gathered whole, a
replicated leaf (``k_up``, ``v_up``) is used whole, and ``wo`` is either a
row block (this rank's block of the output into it, summed over the
group) or replicated (the whole product on every rank, no sum).
Cross-attention (the enc-dec decoder's) runs head-local too: q from the
decoder and K/V from the encoder output each this rank's heads, ``wo`` a
row block summed over the group (:func:`_cross_attend`).

Serving on a mesh (:func:`_attn_tp`, :func:`_cached_attention`):
a cache on the model axis is head-local, this rank's ``Hkv/tp`` heads
with the new K/V written in place; where the KV heads do not divide the
axis the rules replicate the cache, every rank writes the same whole K/V
and each q head reads its KV head (heads that do not divide at all run
every head on every rank, as in training).  Where the batch does not
divide the data axis (B=1) the rules split the cache's slots over it
instead (the dense cache, the ring and MLA's latent): rank ``i`` holds
the i-th contiguous slice, only the owner of a position writes it, and
the softmax is combined across the data group (:func:`_split_attend`:
the max, the sum of exponentials and the weighted values each
all-reduced; a slice that sees no key adds 0).  MLA decodes in the
absorbed form, head-local or over every head as in training, its latent
cache (no head dim) whole on every model rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import mha_ref
import torch.distributed as dist

from repro_torch.launch.collectives import (all_reduce, copy_to, gather,
                                           head_split, model_group,
                                           reduce_from, seq_group, whole)
from repro_torch.launch.sharding import model_sharded
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
    if model_group()[0] is not None and cross_kv is None \
            and model_sharded(h * dh):
        return _attn_tp(p, cfg, x, positions, causal, kv_cache, cache_pos)
    if cross_kv is not None:
        return _cross_attend(p, cfg, x, cross_kv), None
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, h, dh)

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
    b, s = x.shape[:2]
    if kv_cache is not None and seq_group()[0] is not None:
        out = _cached_attention(q, k, v, kv_cache, cache_pos, cfg, causal)
        out = out.transpose(1, 2).reshape(b, s, h * dh)
        return out @ p["wo"], kv_cache
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
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return out @ p["wo"], new_cache


def _proj(p: dict, name: str, bias: str, x, xc, width: int, group):
    """x @ w (+ b): from ``xc`` (``x`` through ``copy_to``) when ``w``
    holds a column block of ``width``; else from ``x``, the full output
    entering through ``copy_to`` (each rank uses it only in part).
    Returns (output, whether it is a block)."""
    sharded = model_sharded(width)
    y = (xc if sharded else x) @ p[name]
    if bias in p:
        y = y + p[bias]
    return (y, True) if sharded else (copy_to(y, group), False)


def _attn_tp(p: dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor, causal: bool,
             kv_cache: Optional[dict] = None,
             cache_pos: Optional[int] = None) -> tuple:
    """Attention on a mesh's model axis that splits ``wq``'s columns
    (module docstring): q head-local; K/V head-local (into a head-local
    cache), or whole with each q head reading its KV head (a cache then
    whole on every rank, every rank writing the same K/V); with heads that
    do not divide the axis, every head on every rank and this rank's block
    of the output into ``wo``.  Returns (out, kv_cache)."""
    group, tp, m = model_group()
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_eff
    b, s, _ = x.shape
    xc = copy_to(x, group)
    q = xc @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    k, k_blk = _proj(p, "wk", "bk", x, xc, hkv * dh, group)
    v, v_blk = _proj(p, "wv", "bv", x, xc, hkv * dh, group)
    rope = positions[:, None, :]

    def attend(q, k, v, kv_sel=None):
        if kv_cache is None:
            return sharded_attention(q, k, v, causal=causal,
                                     window=cfg.sliding_window,
                                     impl=cfg.attn_impl)
        return _cached_attention(q, k, v, kv_cache, cache_pos, cfg, causal,
                                 kv_sel)

    if h % tp == 0:
        hl = h // tp                                  # q heads of this rank
        q = apply_rope(_split_heads(q, hl, dh), rope, cfg.rope_theta)
        kv_sel = None
        if hkv % tp == 0 and k_blk and v_blk:         # K/V head-local too
            k = _split_heads(k, hkv // tp, dh)
            v = _split_heads(v, hkv // tp, dh)
        else:                     # whole K/V; the KV head of each q head
            if k_blk:
                k = gather(k, group, dim=-1, partial=True)
            if v_blk:
                v = gather(v, group, dim=-1, partial=True)
            kv_sel = [(m * hl + i) // (h // hkv) for i in range(hl)]
            k = _split_heads(k, hkv, dh)
            v = _split_heads(v, hkv, dh)
            if kv_cache is None:     # no cache to hold every head: select
                sel = torch.tensor(kv_sel, device=x.device)
                k, v, kv_sel = k[:, sel], v[:, sel], None
        k = apply_rope(k, rope, cfg.rope_theta)
        out = attend(q, k, v, kv_sel)
        out = out.transpose(1, 2).reshape(b, s, hl * dh)
    else:           # heads split across ranks: attend over all of them
        q = gather(q, group, dim=-1, partial=True)
        if k_blk:
            k = gather(k, group, dim=-1, partial=True)
        if v_blk:
            v = gather(v, group, dim=-1, partial=True)
        q = apply_rope(_split_heads(q, h, dh), rope, cfg.rope_theta)
        k = apply_rope(_split_heads(k, hkv, dh), rope, cfg.rope_theta)
        v = _split_heads(v, hkv, dh)
        out = attend(q, k, v)
        n = h * dh // tp
        out = out.transpose(1, 2).reshape(b, s, h * dh)[..., m * n:(m + 1) * n]
    return reduce_from(out @ p["wo"], group), kv_cache


def _write_slots(dst: torch.Tensor, src: torch.Tensor, pos: int, off: int,
                 dim: int) -> None:
    """Write ``src``'s rows of absolute positions ``[pos, pos + n)``
    (along ``dim``) into ``dst``, this rank's slots ``[off, off + L)``:
    only the part that falls in them (none, when this rank does not own
    the position)."""
    n, size = src.shape[dim], dst.shape[dim]
    lo, hi = max(pos, off), min(pos + n, off + size)
    if lo < hi:
        dst.narrow(dim, lo - off, hi - lo).copy_(
            src.narrow(dim, lo - pos, hi - lo).to(dst.dtype))


def _split_attend(q, k, v, q_pos, kv_pos, causal, window, group):
    """``mha_ref``'s maths (positional masks) over this rank's slice of
    the keys, the softmax taken across ``group``: the max, the sum of
    exponentials and the weighted values each reduced over it (a slice
    that sees no key adds 0)."""
    b, hq, sq, dh = q.shape
    hkv = k.shape[1]
    qf = (q.float() * dh ** -0.5).reshape(b, hkv, hq // hkv, sq, dh)
    sc = torch.einsum("bngqd,bnkd->bngqk", qf, k.float())
    iq, jk = q_pos[:, None], kv_pos[None, :]
    mask = jk >= 0
    if causal:
        mask = mask & (jk <= iq)
    if window is not None:
        mask = mask & (jk > iq - window)
    sc = sc.masked_fill(~mask, float("-inf"))
    mx = all_reduce(sc.amax(dim=-1), group, dist.ReduceOp.MAX)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.exp(sc - mx[..., None])
    den = all_reduce(e.sum(dim=-1), group)
    num = all_reduce(torch.einsum("bngqk,bnkd->bngqd", e, v.float()), group)
    out = torch.where(den[..., None] > 0, num / den[..., None], 0.0)
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def _cached_attention(q, k, v, cache: dict, cache_pos: int,
                      cfg: ArchConfig, causal: bool, kv_sel=None):
    """Write the S new K/V rows into ``cache`` in place and attend ``q``
    over it, on a mesh (module docstring): a dense cache or the ring; a
    cache whose slots are split over the data axis (``seq_group``) takes
    only the rows of its slots and the softmax combines over the axis
    (the ring's new tokens are keys on data rank 0 alone).  ``kv_sel``:
    the cache head each of q's heads reads (None: GQA over all)."""
    sg, _, si = seq_group()
    s_new, dev = k.shape[2], q.device
    q_pos = torch.arange(cache_pos, cache_pos + s_new, dtype=torch.int32,
                         device=dev)
    ck, cv = cache["k"], cache["v"]
    n_loc = ck.shape[2]
    off = si * n_loc
    if "slot_pos" in cache:
        spos = cache["slot_pos"]
        size = spos.shape[0]
        # copies of the old ring: its slots are overwritten below
        kv_pos, k_att, v_att = spos[off:off + n_loc], ck, cv
        if si == 0:            # [old ring ++ the new tokens], as _ring_step
            kv_pos = torch.cat([kv_pos, q_pos])
            k_att = torch.cat([k_att.to(k.dtype), k], dim=2)
            v_att = torch.cat([v_att.to(v.dtype), v], dim=2)
        else:
            kv_pos, k_att, v_att = (kv_pos.clone(), k_att.to(k.dtype, copy=True),
                                    v_att.to(v.dtype, copy=True))
        skip = max(s_new - size, 0)
        for slot, o, n in _ring_segments(cache_pos + skip, s_new - skip,
                                         size):
            src = slice(skip + o, skip + o + n)
            _write_slots(ck, k[:, :, src], slot, off, 2)
            _write_slots(cv, v[:, :, src], slot, off, 2)
            spos[slot:slot + n] = q_pos[src]
    else:
        _write_slots(ck, k, cache_pos, off, 2)
        _write_slots(cv, v, cache_pos, off, 2)
        idx = off + torch.arange(n_loc, dtype=torch.int32, device=dev)
        kv_pos = torch.where(idx < cache_pos + s_new, idx, -1)
        k_att, v_att = ck, cv
    if kv_sel is not None:
        if len(set(kv_sel)) == 1:          # one KV head for every q head
            k_att = k_att[:, kv_sel[0]:kv_sel[0] + 1]
            v_att = v_att[:, kv_sel[0]:kv_sel[0] + 1]
        else:
            sel = torch.tensor(kv_sel, device=dev)
            k_att, v_att = k_att[:, sel], v_att[:, sel]
    if sg is None:
        return mha_ref(q, k_att, v_att, causal=causal,
                       window=cfg.sliding_window, q_pos=q_pos, kv_pos=kv_pos)
    return _split_attend(q, k_att, v_att, q_pos, kv_pos, causal,
                         cfg.sliding_window, sg)


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


def _cross_view(p: dict, cfg: ArchConfig) -> tuple:
    """(p, group, local q heads, local KV heads) of cross-attention
    (``collectives.head_split``): head-local when its q and K/V head
    counts both divide the model axis, else the whole layer on every
    rank."""
    h, hkv, dh, d = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_eff,
                     cfg.d_model)
    shapes = {"wq": (d, h * dh), "bq": (h * dh,), "wo": (h * dh, d),
              "wk": (d, hkv * dh), "bk": (hkv * dh,), "wv": (d, hkv * dh),
              "bv": (hkv * dh,)}
    p, group, tp, _ = head_split(p, math.gcd(h, hkv), shapes)
    return p, group, h // tp, hkv // tp


def _cross_attend(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  cross_kv: tuple) -> torch.Tensor:
    """Cross-attention over the encoder K/V of :func:`make_cross_kv`.  On
    a model axis (training): q head-local, ``wo`` a row block and its
    output summed over the group; or, with heads that do not divide the
    axis, the whole layer on every rank."""
    p, group, h, _ = _cross_view(p, cfg)
    dh = cfg.head_dim_eff
    b, s = x.shape[:2]
    q = copy_to(x, group) @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, h, dh)
    k, v = cross_kv                                # precomputed encoder K/V
    sg = seq_group("cross")[0]
    if sg is not None:          # the encoder slots split over data (decode)
        zero = torch.zeros(1, dtype=torch.int32, device=x.device)
        out = _split_attend(q, k, v, zero.expand(s), zero.expand(k.shape[2]),
                            False, None, sg)
    elif s > 1:
        out = sharded_attention(q, k, v, causal=False, window=None,
                                impl=cfg.attn_impl)
    else:
        out = _attend(q, k, v, causal=False, window=None,
                      impl=cfg.attn_impl)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return reduce_from(out @ p["wo"], group)


def make_cross_kv(p: dict, cfg: ArchConfig, enc_out: torch.Tensor):
    """Encoder K/V for the decoder's cross-attention (on a model axis:
    this rank's KV heads, or every head; :func:`_cross_attend`)."""
    p, group, _, hkv = _cross_view(p, cfg)
    dh = cfg.head_dim_eff
    enc = copy_to(enc_out, group)
    k = _split_heads(enc @ p["wk"], hkv, dh)
    v = _split_heads(enc @ p["wv"], hkv, dh)
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

def _mla_up(inp: torch.Tensor, inp_col: torch.Tensor, w: torch.Tensor,
            width: int, group, part: bool,
            heads_local: bool) -> torch.Tensor:
    """``inp @ w`` for an MLA projection of ``width`` columns on the model
    axis in scope, as the rule table laid ``w`` out: a column block
    (``inp_col @ w``) kept head-local, or gathered whole along its last
    dim (``gather(partial=part)``); a replicated ``w`` used whole
    (``inp @ w``), its output through ``copy_to`` when ``part``.
    ``inp_col``: ``copy_to(inp)``, taken once by the caller for all the
    column blocks that read ``inp`` (one gradient sum backward, not one a
    block).  ``part``: the ranks each use the whole projection only in
    part (head-local attention, or a ``wo`` row block); else every rank
    computes the layer whole."""
    if group is None:
        return inp @ w
    if not model_sharded(width):
        y = inp @ w
        return copy_to(y, group) if part else y
    y = inp_col @ w
    return y if heads_local else gather(y, group, dim=-1, partial=part)


def mla_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                kv_cache: Optional[dict] = None,
                cache_pos: Optional[int] = None):
    """Returns (out [B,S,d], kv_cache | None).  With a cache, the S new
    tokens' ``c_kv`` and ``k_rope`` are written at ``cache_pos`` in place;
    a single token then attends in the absorbed form, a prompt in the
    expand form over the cache (positional mask, unwritten rows -1).  On a
    model axis: head-local where the heads divide it, else every head on
    every rank, each projection as its leaf lies (module docstring)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    dev = x.device
    group, tp, mi = model_group()
    local = group is not None and h % tp == 0
    if local:
        h //= tp                      # this rank's heads (module docstring)
    # the ranks each use the activations only in part: head-local, or wo
    # a row block (this rank's block of the output into it, summed)
    part = group is not None and (
        local or model_sharded(cfg.num_heads * m.v_head))

    def up(inp, inp_col, name, width):
        return _mla_up(inp, inp_col, p[name], width, group, part, local)

    ql = rms_norm(x @ p["q_down"], p["q_norm"])
    q = up(ql, copy_to(ql, group), "q_up",
           cfg.num_heads * (m.qk_nope + m.qk_rope))
    q = q.reshape(b, s, h, m.qk_nope + m.qk_rope).transpose(1, 2)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)

    kvd = x @ p["kv_down"]
    c_kv = rms_norm(kvd[..., :m.kv_lora], p["kv_norm"])       # [B,S,kv_lora]
    k_rope = apply_rope(kvd[..., None, m.kv_lora:].transpose(1, 2),
                        positions[:, None, :], cfg.rope_theta)  # [B,1,S,rope]
    if part:
        k_rope = copy_to(k_rope, group)

    sg = None
    if kv_cache is not None:
        c_all, r_all = kv_cache["c_kv"], kv_cache["k_rope"]
        sg, _, si = seq_group()
        sk = c_all.shape[1]                 # this rank's slots
        off = si * sk
        _write_slots(c_all, c_kv, cache_pos, off, 1)
        _write_slots(r_all, k_rope[:, 0], cache_pos, off, 1)
        kv_len = cache_pos + s
        if s == 1:
            # single-token decode: absorbed projections, attention in the
            # compressed c_kv space
            w_up = {k: p[k] for k in ("k_up", "v_up")}
            if group is not None and not local:     # every head: whole
                w_up = {k: whole(v, (m.kv_lora, cfg.num_heads * (
                    m.qk_nope if k == "k_up" else m.v_head)), group,
                    partial=False) for k, v in w_up.items()}
            out = _mla_absorbed_attend(w_up, cfg, q_nope, q_rope, c_all,
                                       r_all, kv_len, b, s, h, off, sg)
            return _mla_out(p, cfg, out, group, mi, tp, local, part), \
                kv_cache
        # multi-token prefill: the expand form over the written cache
        q_pos = cache_pos + torch.arange(s, dtype=torch.int32, device=dev)
        idx = off + torch.arange(sk, dtype=torch.int32, device=dev)
        kv_pos = torch.where(idx < kv_len, idx, -1)
        c_src, r_src, s_kv = c_all, r_all[:, None], sk
    else:
        q_pos = kv_pos = None
        c_src, r_src, s_kv = c_kv, k_rope, s

    # train / prefill: per-head keys and values expanded from the latent
    c_col = copy_to(c_src, group)          # once for k_up's and v_up's
    k_nope = up(c_src, c_col, "k_up", cfg.num_heads * m.qk_nope).reshape(
        b, s_kv, h, m.qk_nope).transpose(1, 2)
    v = up(c_src, c_col, "v_up", cfg.num_heads * m.v_head).reshape(
        b, s_kv, h, m.v_head).transpose(1, 2)
    k = torch.cat([k_nope, r_src.to(k_nope.dtype).expand(
        b, h, s_kv, m.qk_rope)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.qk_nope + m.qk_rope) ** -0.5
    out = _mla_attend(qf, k, v, scale, causal, q_pos, kv_pos, sg)
    out = out.transpose(1, 2).reshape(b, s, h * m.v_head)
    return _mla_out(p, cfg, out, group, mi, tp, local, part), kv_cache


def _mla_out(p: dict, cfg: ArchConfig, out: torch.Tensor, group, mi: int,
             tp: int, local: bool, part: bool) -> torch.Tensor:
    """``out @ wo`` on the model axis in scope: head-local (``out`` this
    rank's heads), or over every head with ``wo`` a row block (``part``:
    this rank's block of ``out``) — each summed over the group — or with
    ``wo`` replicated (the whole product, no sum)."""
    if part and not local:
        n = cfg.num_heads * cfg.mla.v_head // tp
        out = out[..., mi * n:(mi + 1) * n]
    return reduce_from(out @ p["wo"], group if part else None)


def _mla_attend(qf, k, v, scale, causal, q_pos, kv_pos, sg=None):
    """The expand form: the scale folded into q (``mha_ref`` rescales by
    dh^-1/2, dh = qk_nope + qk_rope, while V's head is v_head), then the
    shared multi-token wrapper (over slots split on ``sg``: the combined
    softmax)."""
    dh = qf.shape[-1]
    qs = qf * (scale * dh ** 0.5)
    if sg is not None:
        return _split_attend(qs, k, v, q_pos, kv_pos, causal, None, sg)
    return sharded_attention(qs, k, v, causal=causal, window=None,
                             impl="reference", q_pos=q_pos, kv_pos=kv_pos)


def _mla_absorbed_attend(w_up, cfg, q_nope, q_rope, c_all, r_all, kv_len, b,
                         s, h, off=0, sg=None):
    """Decode with absorbed projections, in f32: k_up folded into q
    (q_c = q_nope · W_kup, [B,H,S,kv_lora]), v_up applied to the context
    per head; the mask (-1e30) covers the whole [S_max] cache.  ``w_up``:
    ``k_up`` and ``v_up`` for ``h`` heads (this rank's, or all of them);
    returns the context before ``wo``, [B, S, h·v_head].  ``off`` /
    ``sg``: the cache holds slots ``[off, off + S)`` of a cache split over
    ``sg``, the softmax combined across it."""
    m = cfg.mla
    w_kup = w_up["k_up"].reshape(m.kv_lora, h, m.qk_nope).float()
    q_c = torch.einsum("bhsn,lhn->bhsl", q_nope.float(), w_kup)
    c32 = c_all.float()
    s_kv = c_all.shape[1]
    logits = torch.einsum("bhsl,btl->bhst", q_c, c32)
    logits = logits + torch.einsum("bhsr,btr->bhst", q_rope.float(),
                                   r_all.float())
    logits = logits * (m.qk_nope + m.qk_rope) ** -0.5
    dev = c_all.device
    t_idx = off + torch.arange(s_kv, device=dev)[None, None, None, :]
    q_idx = (kv_len - s) + torch.arange(s, device=dev)[None, None, :, None]
    logits = torch.where(t_idx <= q_idx, logits, -1e30)
    if sg is None:
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhst,btl->bhsl", probs, c32)
    else:
        mx = all_reduce(logits.amax(dim=-1, keepdim=True), sg,
                        dist.ReduceOp.MAX)
        e = torch.exp(logits - mx)
        ctx = (all_reduce(torch.einsum("bhst,btl->bhsl", e, c32), sg)
               / all_reduce(e.sum(dim=-1, keepdim=True), sg))
    w_vup = w_up["v_up"].reshape(m.kv_lora, h, m.v_head).float()
    out = torch.einsum("bhsl,lhv->bhsv", ctx, w_vup)
    return out.transpose(1, 2).reshape(b, s, h * m.v_head).to(q_nope.dtype)


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
