"""Unified LM model API (port of ``repro.models.lm``; the enc-dec family).

``get_model(cfg)`` returns a :class:`ModelAPI` whose members are plain
functions:

  init(seed=0, device=None)     -> params dict (random, on the device;
                                   None: the GPU)
  loss(params, batch)           -> not ported yet (raises)
  decode_init(batch, cache_len, enc_len, device=None) -> decode state
  decode_step(params, tok, st)  -> (logits [B, V], st')
  prefill(params, tok, st)      -> decode_step over the S prompt tokens

Only the encoder-decoder family (``encoder_layers > 0``, seamless-m4t) is
ported; every other family raises ``NotImplementedError`` naming its
``ROADMAP.md`` item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.common import make_generator

_TODO = "ROADMAP.md Queue A item 9"


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


def _encdec_loss(params, batch):
    raise NotImplementedError(
        f"encdec_loss (enc-dec training) is not ported yet ({_TODO})")


def get_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.encoder_layers > 0:
        dec = lambda p, t, s: encdec.decode_step(p, cfg, t, s)  # noqa: E731
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, device=None: encdec.init_encdec(
                make_generator(seed, device), cfg),
            loss=_encdec_loss,
            decode_init=lambda batch, cache_len, enc_len, device=None: (
                encdec.init_decode_state(cfg, batch, cache_len, enc_len,
                                         device=resolve_device(device))),
            decode_step=dec,
            prefill=dec,
        )
    if cfg.xlstm is not None:
        family = "the xLSTM LM"
    elif cfg.ssm is not None:
        family = "the SSM / hybrid LM"
    elif cfg.moe is not None:
        family = "the MoE decoder-only LM"
    else:
        family = "the decoder-only LM"
    raise NotImplementedError(
        f"{cfg.name}: {family} is not ported yet ({_TODO}); only the "
        f"encoder-decoder family (seamless-m4t) runs in the port")
