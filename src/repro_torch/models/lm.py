"""Unified LM model API (port of ``repro.models.lm``): the encoder-decoder
family, the decoder-only family (dense, VLM, and MoE with MLA or GQA
attention), the xLSTM family and the SSM / hybrid family.

``get_model(cfg)`` returns a :class:`ModelAPI` whose members are plain
functions:

  init(seed=0, device=None)     -> params dict (random, on the device;
                                   None: the GPU)
  loss(params, batch)           -> scalar CE (f32)
  decode_init(batch, cache_len[, enc_len], device=None) -> decode state
                                   (enc-dec takes ``enc_len``; xLSTM's
                                   ``cache_len`` defaults to 0, unused)
  decode_step(params, tok, st)  -> (logits [B, V], st')
  prefill(params, tok, st)      -> attention families: decode_step over the
                                   S prompt tokens; recurrent families: the
                                   parallel forward's last logits, ``st``
                                   handed back unchanged (the reference's)

Batch layouts by family (the reference's):
  decoder       {"tokens": [B, S]}
  vlm           {"tokens": [B, S - P], "patch_embeds": [B, P, d]}
  audio enc-dec {"frame_embeds": [B, S/4, d], "tokens": [B, 3S/4]}
  ssm/hybrid    {"tokens": [B, S]}
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, transformer, xlstm_lm
from repro_torch.models.common import make_generator


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Any]
    loss: Callable[[Any, dict], torch.Tensor]
    decode_init: Callable[..., Any]
    decode_step: Callable[[Any, torch.Tensor, Any], tuple]
    prefill: Callable[[Any, torch.Tensor, Any], tuple] = None


def enc_dec_split(cfg: ArchConfig, seq_len: int) -> tuple[int, int]:
    """(S_enc, S_dec) with S_enc + S_dec == seq_len (audio enc-dec)."""
    s_enc = max(seq_len // 4, 1)
    return s_enc, seq_len - s_enc


def get_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.encoder_layers > 0:
        dec = lambda p, t, s: encdec.decode_step(p, cfg, t, s)  # noqa: E731
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, device=None: encdec.init_encdec(
                make_generator(seed, device), cfg),
            loss=lambda p, b: encdec.encdec_loss(p, cfg, b),
            decode_init=lambda batch, cache_len, enc_len, device=None: (
                encdec.init_decode_state(cfg, batch, cache_len, enc_len,
                                         device=resolve_device(device))),
            decode_step=dec,
            prefill=dec,
        )
    if cfg.xlstm is not None:
        def xl_prefill(p, t, s):
            return xlstm_lm.xlstm_forward(p, cfg, t)[:, -1], s
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, device=None: xlstm_lm.init_xlstm_lm(
                make_generator(seed, device), cfg),
            loss=lambda p, b: xlstm_lm.xlstm_loss(p, cfg, b),
            decode_init=lambda batch, cache_len=0, device=None: (
                xlstm_lm.init_decode_state(cfg, batch,
                                           device=resolve_device(device))),
            decode_step=lambda p, t, s: xlstm_lm.decode_step(p, cfg, t, s),
            prefill=xl_prefill,
        )
    if cfg.ssm is not None:
        def hy_prefill(p, t, s):
            return hybrid.hybrid_forward(p, cfg, t)[:, -1], s
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, device=None: hybrid.init_hybrid(
                make_generator(seed, device), cfg),
            loss=lambda p, b: hybrid.hybrid_loss(p, cfg, b),
            decode_init=lambda batch, cache_len, device=None: (
                hybrid.init_decode_state(cfg, batch, cache_len,
                                         device=resolve_device(device))),
            decode_step=lambda p, t, s: hybrid.decode_step(p, cfg, t, s),
            prefill=hy_prefill,
        )
    dec = lambda p, t, s: transformer.lm_decode_step(p, cfg, t, s)  # noqa: E731
    return ModelAPI(
        cfg=cfg,
        init=lambda seed=0, device=None: transformer.init_lm(
            make_generator(seed, device), cfg),
        loss=lambda p, b: transformer.lm_loss(p, cfg, b),
        decode_init=lambda batch, cache_len, device=None: (
            transformer.init_decode_state(cfg, batch, cache_len,
                                          device=resolve_device(device))),
        decode_step=dec,
        prefill=dec,
    )


def make_batch(cfg: ArchConfig, seq_len: int, batch: int,
               gen: Optional[torch.Generator] = None, device=None) -> dict:
    """A random batch of the family's layout (smoke tests, examples), drawn
    from ``gen`` (default: seed 0) on its device (``device``; None: the
    GPU)."""
    gen = gen if gen is not None else make_generator(0, device)
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def tokens(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    if cfg.encoder_layers > 0:
        s_enc, s_dec = enc_dec_split(cfg, seq_len)
        return {"frame_embeds": normal(batch, s_enc, cfg.d_model),
                "tokens": tokens(batch, s_dec)}
    if cfg.frontend == "vision":
        p = min(cfg.frontend_tokens, max(seq_len - 1, 1))
        return {"patch_embeds": normal(batch, p, cfg.d_model),
                "tokens": tokens(batch, seq_len - p)}
    return {"tokens": tokens(batch, seq_len)}
