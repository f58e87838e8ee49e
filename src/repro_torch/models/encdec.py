"""Encoder-decoder assembly (seamless-m4t): bidirectional encoder over stub
frame embeddings + causal decoder with cross-attention (port of
``repro.models.encdec``).

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, S_enc, d_model].  Encoder and decoder
stacks keep the reference's stacked layout ([L, ...] leaves) and run as a
loop over layers (``scan_util.scan``); in training ``cfg.remat`` runs each
layer under ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` of its scan body.

Decode: per-layer self-attention KV caches + per-layer precomputed cross
K/V ([L, B, Hkv, S_enc, Dh], from :func:`prefill_encoder`), so each decode
step re-reads the cross context but never re-runs the encoder.  The caches
are written in place (see ``models/attention.py``): the state that
:func:`decode_step` returns holds the same cache tensors as the one it was
given, and its ``pos`` is a Python int.

On a mesh's model axis (training), both stacks run the tensor-parallel
branches of ``models/attention.py`` and ``models/ffn.py`` (the decoder's
cross-attention head-local), the untied input table's d_model columns are
gathered and the unembedding holds this rank's vocab columns, which the
cross-entropy reduces (``vocab``); a vocab the axis does not divide stays
whole (the rule table's fallback) and takes the plain cross-entropy.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import scan_util
from repro_torch.models.common import (cross_entropy, embed_init, full_logits,
                                       model_dtype, rms_norm, stack_init,
                                       zeros)
from repro_torch.models.transformer import (embed_tokens, token_positions,
                                            unembed)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _init_enc_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {
        "norm1": zeros(gen, (cfg.d_model,)),
        "norm2": zeros(gen, (cfg.d_model,)),
        "attn": attn.init_attn(gen, cfg),
        "ffn": ffn_mod.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                                model_dtype(cfg)),
    }


def _init_dec_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {
        "norm1": zeros(gen, (cfg.d_model,)),
        "norm_x": zeros(gen, (cfg.d_model,)),
        "norm2": zeros(gen, (cfg.d_model,)),
        "attn": attn.init_attn(gen, cfg),
        "xattn": attn.init_attn(gen, cfg, cross=True),
        "ffn": ffn_mod.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                                model_dtype(cfg)),
    }


def init_encdec(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters in the reference's layout, on ``gen``'s device."""
    dt = model_dtype(cfg)
    return {
        "embed_in": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": zeros(gen, (cfg.d_model,)),
        "unembed": embed_init(gen, cfg.d_model, cfg.vocab_size, dt),
        "encoder": stack_init(gen, cfg.encoder_layers,
                              lambda g: _init_enc_block(g, cfg)),
        "decoder": stack_init(gen, cfg.num_layers,
                              lambda g: _init_dec_block(g, cfg)),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(params: dict, cfg: ArchConfig,
           frame_embeds: torch.Tensor) -> torch.Tensor:
    """frame_embeds [B, S_enc, d] -> encoder output [B, S_enc, d]."""
    h = frame_embeds.to(model_dtype(cfg))
    b, s, _ = h.shape
    positions = token_positions(b, s, 0, h.device)

    def body(x, bp):
        a, _ = attn.attn_forward(bp["attn"], cfg, rms_norm(x, bp["norm1"]),
                                 positions, causal=False)
        x = x + a
        x = x + ffn_mod.ffn_forward(bp["ffn"], cfg.ffn_act,
                                    rms_norm(x, bp["norm2"]), cfg.gated_ffn,
                                    d_ff=cfg.d_ff)
        return x, None

    h, _ = scan_util.scan(body, h, params["encoder"], remat=cfg.remat)
    return h


def prefill_encoder(params: dict, cfg: ArchConfig,
                    frame_embeds: torch.Tensor) -> dict:
    """Run the encoder once and project per-decoder-layer cross K/V:
    leaves [L, B, Hkv, S_enc, Dh], contiguous."""
    enc_out = encode(params, cfg, frame_embeds)

    def project(_, bp):
        k, v = attn.make_cross_kv(bp["xattn"], cfg, enc_out)
        return None, {"k": k, "v": v}

    _, cross = scan_util.scan(project, None, params["decoder"])
    return cross


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _dec_block(bp, cfg: ArchConfig, h, positions, enc_out=None,
               cross_kv=None, cache=None, cache_pos=None):
    """One decoder block.  Cross K/V either projected from enc_out (train)
    or precomputed (decode)."""
    a, new_cache = attn.attn_forward(bp["attn"], cfg, rms_norm(h, bp["norm1"]),
                                     positions, kv_cache=cache,
                                     cache_pos=cache_pos)
    h = h + a
    if cross_kv is None:
        cross_kv = attn.make_cross_kv(bp["xattn"], cfg, enc_out)
    xa, _ = attn.attn_forward(bp["xattn"], cfg, rms_norm(h, bp["norm_x"]),
                              positions, cross_kv=cross_kv)
    h = h + xa
    h = h + ffn_mod.ffn_forward(bp["ffn"], cfg.ffn_act,
                                rms_norm(h, bp["norm2"]), cfg.gated_ffn,
                                d_ff=cfg.d_ff)
    return h, new_cache


def encdec_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """batch: frame_embeds [B, S_enc, d] + tokens [B, S_dec] -> next-token
    CE of the decoder."""
    enc_out = encode(params, cfg, batch["frame_embeds"])
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    positions = token_positions(b, s, 0, h.device)

    def body(carry, bp):
        return _dec_block(bp, cfg, carry, positions, enc_out=enc_out)[0], None

    h, _ = scan_util.scan(body, h, params["decoder"], remat=cfg.remat)
    logits = unembed(params, cfg, h)
    return cross_entropy(logits[:, :-1], tokens[:, 1:],
                         vocab=cfg.vocab_size)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      enc_len: int, *, device) -> dict:
    """Zero self-attention caches + zero cross-KV slots (filled by
    prefill); ``pos`` 0."""
    caches = attn.init_kv_cache(cfg, batch, cache_len, device=device)
    caches = scan_util.tree_map(
        lambda x: x[None].repeat(cfg.num_layers, *([1] * x.dim())), caches)
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_eff
    shape = (cfg.num_layers, batch, hkv, enc_len, dh)
    cdt = attn.cache_dtype(cfg)
    cross = {"k": torch.zeros(shape, dtype=cdt, device=device),
             "v": torch.zeros(shape, dtype=cdt, device=device)}
    return {"caches": caches, "cross": cross, "pos": 0}


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                state: dict) -> tuple[torch.Tensor, dict]:
    """tokens [B, S] (S prompt tokens at prefill, 1 per decode step) ->
    (logits of the last position [B, V], state with pos + S)."""
    h = embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    pos = state["pos"]
    positions = token_positions(b, s, pos, h.device)

    def body(carry, xs):
        bp, cache, cross = xs
        out, _ = _dec_block(bp, cfg, carry, positions,
                            cross_kv=(cross["k"], cross["v"]),
                            cache=cache, cache_pos=pos)
        return out, None                       # caches written in place

    h, _ = scan_util.scan(body, h, (params["decoder"], state["caches"],
                                    state["cross"]))
    logits = full_logits(unembed(params, cfg, h)[:, -1], cfg.vocab_size)
    return logits, {"caches": state["caches"],
                           "cross": state["cross"], "pos": pos + s}
