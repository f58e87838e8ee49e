"""Public entry points of the ported kernels (single device, no mesh).

Dispatch is by device alone, the same for every op: a CPU tensor runs the
plain PyTorch version, a CUDA tensor launches the hand-written CUDA kernel
— or the wrapper raises.  There is no fallback from a CUDA tensor to the
plain version, and no option that selects one.

Gradients follow the reference (``repro.kernels.ops``):

* :func:`cache_lookup_agg` (K1) is a ``torch.autograd.Function`` whose
  backward is the plain-torch port of the reference's hand-written VJP
  (``_fused_bwd``, single-device branch), on both devices: ``dw`` is the
  lanes' rows against the incoming gradient, and the lanes' ``w·g`` are
  scatter-added into ``dcache`` (hits) and ``dstreamed`` (misses).  The
  reference's backward is plain jnp, not Pallas, so no kernel is needed.
* :func:`gather_agg` (K2) has no backward in the reference: ``jax.grad``
  through its Pallas call raises.  Here it raises ``NotImplementedError``
  too, when grad mode is on and an operand requires grad; training runs
  the upper layers through ``aggregate_impl="reference"``.
* :func:`flash_attention` (K4) has no backward in the reference either; it
  raises ``NotImplementedError`` under grad the same way.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cache_lookup import (cache_lookup_agg_cuda,
                                              cache_lookup_agg_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.gather_agg import gather_agg_cuda, gather_agg_plain


def gather_agg(feat: torch.Tensor, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Fused gather + weighted aggregation (K2).  [B, D] f32.  Forward
    only, as the reference's."""
    if torch.is_grad_enabled() and (feat.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "gather_agg (K2) has no backward, as in the reference; train "
            "with ModelConfig(aggregate_impl='reference')")
    if not feat.is_cuda:
        return gather_agg_plain(feat, idx, w)
    return gather_agg_cuda(feat, idx, w)


class _CacheLookupAgg(torch.autograd.Function):
    """K1 forward by device; the reference's VJP in plain torch."""

    @staticmethod
    def forward(ctx, cache_table, streamed, slots, idx, w):
        ctx.save_for_backward(cache_table, streamed, slots, idx, w)
        if not cache_table.is_cuda:
            return cache_lookup_agg_plain(cache_table, streamed, slots, idx,
                                          w)
        return cache_lookup_agg_cuda(cache_table, streamed, slots, idx, w)

    @staticmethod
    def backward(ctx, g):
        cache_table, streamed, slots, idx, w = ctx.saved_tensors
        need_cache, need_streamed, _, _, need_w = ctx.needs_input_grad
        g = g.float()
        idx_l = idx.long()
        lane_slots = slots.long()[idx_l]                          # [B, K]
        hit = (lane_slots >= 0)[..., None]
        hit_rows = lane_slots.clamp(min=0)
        dcache = dstreamed = dw = None
        if need_w:
            h0 = torch.where(hit, cache_table[hit_rows].float(),
                             streamed[idx_l].float())             # [B, K, D]
            dw = torch.einsum("bd,bkd->bk", g, h0).to(w.dtype)
        if need_cache or need_streamed:
            d = g.shape[1]
            dlane = w.float()[..., None] * g[:, None, :]          # [B, K, D]
            zero = torch.zeros((), device=g.device)
            if need_cache:
                dcache = torch.zeros_like(cache_table).index_add_(
                    0, hit_rows.reshape(-1),
                    torch.where(hit, dlane, zero).reshape(-1, d)
                    .to(cache_table.dtype))
            if need_streamed:
                dstreamed = torch.zeros_like(streamed).index_add_(
                    0, idx_l.reshape(-1),
                    torch.where(hit, zero, dlane).reshape(-1, d)
                    .to(streamed.dtype))
        return dcache, dstreamed, None, None, dw


def cache_lookup_agg(cache_table: torch.Tensor, streamed: torch.Tensor,
                     slots: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Fused GNS input layer (K1): cache/streamed select + gather-agg.
    [B, D] f32.  Differentiable in ``cache_table``, ``streamed`` and ``w``
    (the reference's VJP, plain torch on both devices)."""
    return _CacheLookupAgg.apply(cache_table, streamed, slots, idx, w)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked attention (K4).  q [B, Hq, Sq, Dh], k/v [B, Hkv, Sk, Dh] ->
    q's shape and dtype.  The reference's semantics (``repro.kernels.ops
    .flash_attention``): queries end-aligned to the keys, ``q_offset = Sk -
    Sq`` and ``kv_len = Sk`` from the unpadded lengths.  The reference pads
    Sq and Sk to its blocks; K4 masks its ragged edges itself, so nothing is
    padded here.  Forward only, as the reference's."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention (K4) has no backward, as in the reference; "
            "train with ArchConfig(attn_impl='reference')")
    sq, sk = q.shape[2], k.shape[2]
    kw = dict(causal=causal, window=window, scale=scale, kv_len=sk,
              q_offset=sk - sq)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, **kw)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), **kw)
