"""Decoder-only LM assembly: the dense, MoE, MLA and VLM backbones (port
of ``repro.models.transformer``).

Layers are stacked (parameters carry a leading ``[L, ...]`` axis per layer
group, the reference's layout) and run as a loop over layers
(``scan_util.scan``).  ``cfg.remat`` runs each block of a training forward
under ``torch.utils.checkpoint`` (save nothing inside the block, recompute
it in backward), the port's ``jax.checkpoint``.

Heterogeneous stacks (deepseek's leading dense layers before its MoE
layers) are consecutive layer groups, as in the reference.

Decode: stacked per-layer caches written in place (dense KV, the
sliding-window ring of ``models/attention.py``, or MLA's compressed
cache); the state's ``pos`` is a Python int.

On a mesh (``launch.sharding.use_mesh``), the blocks run their tensor-
and expert-parallel forms, and the embedding and unembedding follow the
rule table: a tied table split by vocab rows (a masked lookup summed over
the model group; the logits this rank's vocab slice, reduced by the
vocab-parallel cross-entropy), an untied input table by d_model columns
(gathered), an untied unembedding by vocab columns.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.collectives import (copy_to, gather, model_group,
                                           vocab_embed)
from repro_torch.launch.sharding import model_sharded
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import scan_util
from repro_torch.models.common import (chunked_unembed_ce, cross_entropy,
                                       embed_init, full_logits, grad_cast,
                                       model_dtype, rms_norm, stack_init,
                                       zeros)

# ---------------------------------------------------------------------------
# one transformer block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    p = {
        "norm1": zeros(gen, (cfg.d_model,)),
        "norm2": zeros(gen, (cfg.d_model,)),
        "attn": attn.init_attn(gen, cfg),
    }
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg)
    else:
        p["ffn"] = ffn_mod.init_ffn(gen, cfg.d_model, cfg.d_ff,
                                    cfg.gated_ffn, model_dtype(cfg))
    return p


def block_forward(bp: dict, cfg: ArchConfig, h: torch.Tensor,
                  positions: torch.Tensor, kind: str,
                  cache: Optional[dict] = None, cache_pos=None):
    a, new_cache = attn.attn_forward(bp["attn"], cfg, rms_norm(h, bp["norm1"]),
                                     positions, kv_cache=cache,
                                     cache_pos=cache_pos)
    h = h + a
    x2 = rms_norm(h, bp["norm2"])
    if kind == "moe":
        h = h + moe_mod.moe_forward(bp["moe"], cfg, x2)
    else:
        h = h + ffn_mod.ffn_forward(bp["ffn"], cfg.ffn_act, x2,
                                    cfg.gated_ffn, d_ff=cfg.d_ff)
    if cfg.bf16_grad_stream:
        h = grad_cast(h)          # backward cotangent pinned to h.dtype
    return h, new_cache


# ---------------------------------------------------------------------------
# layer groups
# ---------------------------------------------------------------------------

def layer_groups(cfg: ArchConfig) -> list[tuple[str, int, str]]:
    """[(group_name, num_layers, block_kind)] — layer groups in order."""
    if cfg.moe is not None:
        nd = cfg.moe.first_dense_layers
        groups = []
        if nd:
            groups.append(("layers_dense", nd, "dense"))
        groups.append(("layers_moe", cfg.num_layers - nd, "moe"))
        return groups
    return [("layers", cfg.num_layers, "dense")]


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters in the reference's layout, on ``gen``'s device.
    A tied table is ``embed``, an untied one ``embed_in`` (+ ``unembed``),
    as the reference names them."""
    dt = model_dtype(cfg)
    in_key = "embed" if cfg.tie_embeddings else "embed_in"
    params = {
        in_key: embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": zeros(gen, (cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.d_model, cfg.vocab_size, dt)
    for name, n, kind in layer_groups(cfg):
        params[name] = stack_init(gen, n, lambda g, kind=kind: init_block(
            g, cfg, kind))
    return params


def _scan_group(params_g, cfg: ArchConfig, h, positions, kind: str,
                caches=None, cache_pos=None):
    if caches is None:
        def body(carry, bp):
            return block_forward(bp, cfg, carry, positions, kind)[0], None

        return scan_util.scan(body, h, params_g, remat=cfg.remat)[0]

    def decode_body(carry, xs):
        bp, cache = xs
        out, _ = block_forward(bp, cfg, carry, positions, kind, cache=cache,
                               cache_pos=cache_pos)
        return out, None                         # caches written in place

    return scan_util.scan(decode_body, h, (params_g, caches))[0]


# ---------------------------------------------------------------------------
# train / prefill forward
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings [B, S, d].  On a mesh whose model axis shards
    the table (the rule table: a tied ``embed`` by vocab rows, an untied
    ``embed_in`` by d_model columns), a masked lookup of the local rows
    summed over the model group, or the local columns gathered."""
    group, _, index = model_group()
    if "embed_in" in params:
        h = params["embed_in"][tokens.long()]
        if group is not None and model_sharded(cfg.d_model):
            h = gather(h, group, dim=-1, partial=False)
    elif group is not None and model_sharded(cfg.vocab_size):
        h = vocab_embed(params["embed"], tokens, group, index)
    else:
        h = params["embed"][tokens.long()]
    if cfg.scale_embed:
        h = h * (cfg.d_model ** 0.5)
    return h


def unembed_weight(params: dict, cfg: ArchConfig) -> torch.Tensor:
    """[d, V] (on a mesh that shards the vocab: this rank's V columns)."""
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def unembed(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits [..., V]: on a mesh that shards the vocab, this rank's
    slice (``cross_entropy(..., vocab=)`` reduces over it)."""
    h = rms_norm(h, params["final_norm"])
    if model_sharded(cfg.vocab_size):
        h = copy_to(h, model_group()[0])
    return h @ unembed_weight(params, cfg)


def token_positions(b: int, s: int, start: int, device) -> torch.Tensor:
    """[B, S] int32 positions start..start+S-1 (a broadcast view)."""
    return (start + torch.arange(s, dtype=torch.int32,
                                 device=device))[None].expand(b, s)


def lm_forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None,
               return_hidden: bool = False) -> torch.Tensor:
    """tokens [B, S_text]; prefix_embeds [B, P, d] (VLM stub frontend)."""
    h = embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    b, s, _ = h.shape
    positions = token_positions(b, s, 0, h.device)
    for name, _, kind in layer_groups(cfg):
        h = _scan_group(params[name], cfg, h, positions, kind)
    if return_hidden:
        return h
    return unembed(params, cfg, h)


def lm_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Next-token CE.  batch: tokens [B,S] (+ patch_embeds for vlm)."""
    tokens = batch["tokens"]
    prefix = batch.get("patch_embeds")
    if cfg.chunked_ce:
        h = lm_forward(params, cfg, tokens, prefix_embeds=prefix,
                       return_hidden=True)
        if prefix is not None:
            h = h[:, prefix.shape[1]:]
        h = rms_norm(h, params["final_norm"])
        b, s = tokens.shape
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                           dim=1)
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
        mask[:, -1] = 0.0
        return chunked_unembed_ce(h, unembed_weight(params, cfg), labels,
                                  mask, cfg.chunked_ce, vocab=cfg.vocab_size)
    logits = lm_forward(params, cfg, tokens, prefix_embeds=prefix)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]          # text positions only
    return cross_entropy(logits[:, :-1], tokens[:, 1:], vocab=cfg.vocab_size)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device) -> dict:
    """Stacked per-layer caches and ``pos`` 0: KV, or MLA's compressed
    cache.  A sliding-window config allocates a ring of window size
    (``min(cache_len, window)`` rows)."""
    eff_len = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
               else cache_len)
    if cfg.mla is not None:
        one = attn.init_mla_cache(cfg, batch, eff_len, device=device)
    else:
        one = attn.init_kv_cache(cfg, batch, eff_len, device=device)
    groups = {name: scan_util.tree_map(
        lambda x, n=n: x[None].repeat(n, *([1] * x.dim())), one)
        for name, n, _ in layer_groups(cfg)}
    return {"caches": groups, "pos": 0}


def lm_decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                   state: dict) -> tuple[torch.Tensor, dict]:
    """tokens [B, S_new] (the prompt at prefill, 1 per decode step) ->
    (logits of the last position [B, V], state with pos + S_new)."""
    h = embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    pos = state["pos"]
    positions = token_positions(b, s, pos, h.device)
    for name, _, kind in layer_groups(cfg):
        h = _scan_group(params[name], cfg, h, positions, kind,
                        caches=state["caches"][name], cache_pos=pos)
    logits = unembed(params, cfg, h)[:, -1]
    return full_logits(logits, cfg.vocab_size), {"caches": state["caches"],
                                                 "pos": pos + s}
