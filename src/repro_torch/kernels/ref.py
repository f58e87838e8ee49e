"""Plain PyTorch versions of every ported kernel, under the names of
``repro/kernels/ref.py`` (the oracles the tests hold the kernels to).

The gather plain versions live beside their kernels' wrappers; this module
collects them.  :func:`mha_ref` is defined here: it is the reference's own
attention (the models call it directly wherever the reference does), and
K4's plain version (:mod:`repro_torch.kernels.flash_attention`) is built
on it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cache_lookup import (
    cache_lookup_agg_plain as cache_lookup_agg_ref)
from repro_torch.kernels.gather_agg import gather_agg_plain as gather_agg_ref

__all__ = ["gather_agg_ref", "cache_lookup_agg_ref", "mha_ref"]


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None, kv_len=None, q_pos=None, kv_pos=None) -> torch.Tensor:
    """Multi-head attention with GQA, causal and sliding-window masks.

    q: [B, Hq, Sq, Dh]; k, v: [B, Hkv, Sk, Dh] with Hq % Hkv == 0 (the kv
    head of q head h is h // (Hq / Hkv), a grouped einsum: k/v are never
    repeated to Hq heads).  ``kv_len`` masks keys at positions >= it and
    end-aligns the queries to it (decode with a partly filled cache).
    ``q_pos`` [Sq] / ``kv_pos`` [Sk]: explicit absolute positions (ring
    caches, prefill over a dense cache); keys with ``kv_pos < 0`` are
    unwritten and masked; they override the ``kv_len`` alignment.
    Computes in f32, returns q's dtype; a row that sees no key is 0.
    Under ``probe_ctx.linear_attention_traffic`` a multi-token call
    computes the reference's linear stand-in instead (the dry-run's bytes).
    """
    b, hq, sq, dh = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    qf = (q.float() * scale).reshape(b, hkv, g, sq, dh)
    kf = k.float()
    vf = v.float()
    from repro_torch.kernels.probe_ctx import linear_attention_on
    if linear_attention_on() and sq > 1:
        # the flash kernel's HBM-traffic stand-in (kernels/probe_ctx.py):
        # q/k/v read once, out written once, O(S) intermediates only
        kv = torch.einsum("bnkd,bnke->bnde", kf, vf)         # [b,n,dh,dv]
        out = torch.einsum("bngqd,bnde->bngqe", qf, kv)
        return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)
    s = torch.einsum("bngqd,bnkd->bngqk", qf, kf)
    if q_pos is not None:
        iq = q_pos[:, None]
        jk = kv_pos[None, :]
        mask = jk >= 0                         # unwritten slots
        if causal:
            mask = mask & (jk <= iq)
        if window is not None:
            mask = mask & (jk > iq - window)
    else:
        end = sk if kv_len is None else kv_len
        iq = torch.arange(sq, device=q.device)[:, None] + (end - sq)
        jk = torch.arange(sk, device=q.device)[None, :]
        mask = jk < end                        # padded / unwritten rows
        if causal:
            mask = mask & (jk <= iq)
        if window is not None:
            mask = mask & (jk > iq - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)    # fully masked rows -> 0
    out = torch.einsum("bngqk,bnkd->bngqd", p, vf)
    out = out.reshape(b, hq, sq, v.shape[-1])
    return out.to(q.dtype)
