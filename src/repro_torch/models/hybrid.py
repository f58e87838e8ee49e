"""Hybrid Mamba2 + shared-attention assembly, zamba2-2.7b (port of
``repro.models.hybrid``).

Structure: ``num_layers`` Mamba2 blocks; after every ``shared_attn_every``
of them, ONE shared transformer block (self-attention + FFN, a single
parameter set reused by every invocation) runs, zamba2's parameter-sharing
trick.  With 54 layers and cadence 6 that is 9 invocations of the shared
block, each with its own KV cache (weights shared, state not).

Layer loop: over the 9 groups, each a loop over its 6 Mamba2 blocks (the
``[54, ...]`` stack viewed as ``[9, 6, ...]``) followed by the shared block.
``cfg.remat`` runs each Mamba2 block of a training forward under
``torch.utils.checkpoint``, as the reference checkpoints its scan body.

Pure-SSM configs (``shared_attn_every == 0``) run one loop over all Mamba2
blocks.  Decode states are real allocations: the recurrent states are
updated and the KV caches written in place (``models/ssm.py``,
``models/attention.py``); ``pos`` is a Python int.

On a mesh's model axis (training), the Mamba2 blocks run their heads
(``models/ssm.py``), the shared block the dense tensor-parallel branches
of attention and FFN (the rule table reaches its leaves under ``shared/``
by their names), and the embeddings follow the rule table as the
decoder-only family's do (``models/transformer.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import scan_util, ssm
from repro_torch.models.common import (cross_entropy, embed_init,
                                       full_logits, model_dtype, rms_norm,
                                       stack_init, zeros)
from repro_torch.models.transformer import (embed_tokens, token_positions,
                                            unembed)


def group_dims(cfg: ArchConfig) -> tuple[int, int]:
    """(num_groups, group_size); group_size == num_layers if no shared
    attention."""
    c = cfg.shared_attn_every
    if not c:
        return 1, cfg.num_layers
    assert cfg.num_layers % c == 0, (cfg.num_layers, c)
    return cfg.num_layers // c, c


def _init_mamba_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"norm": zeros(gen, (cfg.d_model,)),
            "cell": ssm.init_ssm(gen, cfg)}


def _init_shared_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {
        "norm1": zeros(gen, (cfg.d_model,)),
        "norm2": zeros(gen, (cfg.d_model,)),
        "attn": attn.init_attn(gen, cfg),
        "ffn": ffn_mod.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                                model_dtype(cfg)),
    }


def init_hybrid(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters in the reference's layout, on ``gen``'s device."""
    dt = model_dtype(cfg)
    in_key = "embed" if cfg.tie_embeddings else "embed_in"
    params = {
        in_key: embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": zeros(gen, (cfg.d_model,)),
        "mamba_layers": stack_init(gen, cfg.num_layers,
                                   lambda g: _init_mamba_block(g, cfg)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.d_model, cfg.vocab_size, dt)
    if cfg.shared_attn_every:
        params["shared"] = _init_shared_block(gen, cfg)
    return params


def _regroup(tree, g: int, c: int):
    """[L, ...] stacked params -> [G, C, ...] (views)."""
    return scan_util.tree_map(lambda x: x.reshape(g, c, *x.shape[1:]), tree)


def _mamba_scan(params_c, cfg: ArchConfig, h, states=None):
    """The Mamba2 blocks of ``params_c`` over ``h``; with ``states`` (one
    per block, stacked) the recurrent form, each updated in place.
    Remat only without states, as in the reference."""
    if states is None:
        def body(carry, bp):
            out, _ = ssm.ssm_forward(bp["cell"], cfg,
                                     rms_norm(carry, bp["norm"]))
            return carry + out, None

        return scan_util.scan(body, h, params_c, remat=cfg.remat)[0]

    def decode_body(carry, xs):
        bp, st = xs
        out, _ = ssm.ssm_forward(bp["cell"], cfg, rms_norm(carry, bp["norm"]),
                                 state=st)
        return carry + out, None

    return scan_util.scan(decode_body, h, (params_c, states))[0]


def _shared_block(sp, cfg: ArchConfig, h, positions, cache=None,
                  cache_pos=None):
    a, new_cache = attn.attn_forward(sp["attn"], cfg, rms_norm(h, sp["norm1"]),
                                     positions, kv_cache=cache,
                                     cache_pos=cache_pos)
    h = h + a
    h = h + ffn_mod.ffn_forward(sp["ffn"], cfg.ffn_act,
                                rms_norm(h, sp["norm2"]), cfg.gated_ffn,
                                d_ff=cfg.d_ff)
    return h, new_cache


def hybrid_forward(params: dict, cfg: ArchConfig,
                   tokens: torch.Tensor) -> torch.Tensor:
    h = embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    if not cfg.shared_attn_every:
        return unembed(params, cfg, _mamba_scan(params["mamba_layers"], cfg,
                                                h))
    positions = token_positions(b, s, 0, h.device)
    shared = params["shared"]

    def group_body(carry, params_g):
        x = _mamba_scan(params_g, cfg, carry)
        return _shared_block(shared, cfg, x, positions)[0], None

    h, _ = scan_util.scan(group_body, h,
                          _regroup(params["mamba_layers"], *group_dims(cfg)))
    return unembed(params, cfg, h)


def hybrid_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Next-token CE (plain; ``chunked_ce`` does not apply, as in the
    reference)."""
    tokens = batch["tokens"]
    logits = hybrid_forward(params, cfg, tokens)
    return cross_entropy(logits[:, :-1], tokens[:, 1:],
                         vocab=cfg.vocab_size)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device) -> dict:
    """Zero recurrent states, ``[G, C, ...]`` (flat ``[L, ...]`` for a
    pure-SSM config), and with shared attention one KV cache of
    ``cache_len`` rows per group, ``[G, ...]``: each a tensor of its own
    (``repeat``, never a broadcast view), as decode writes them in place."""
    g, c = group_dims(cfg)
    lead = (g, c) if cfg.shared_attn_every else (cfg.num_layers,)
    one = ssm.init_ssm_state(cfg, batch, device=device)
    state = {"mamba": scan_util.tree_map(
        lambda x: x.repeat(*lead, *([1] * x.dim())), one), "pos": 0}
    if cfg.shared_attn_every:
        kv = attn.init_kv_cache(cfg, batch, cache_len, device=device)
        state["shared_kv"] = scan_util.tree_map(
            lambda x: x.repeat(g, *([1] * x.dim())), kv)
    return state


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                state: dict) -> tuple[torch.Tensor, dict]:
    """tokens [B, S_new] (the prompt at prefill, 1 per decode step) ->
    (logits of the last position [B, V], state with pos + S_new; its
    tensors updated in place)."""
    h = embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    pos = state["pos"]
    out = {"mamba": state["mamba"], "pos": pos + s}
    if not cfg.shared_attn_every:
        h = _mamba_scan(params["mamba_layers"], cfg, h, states=state["mamba"])
        return full_logits(unembed(params, cfg, h)[:, -1], cfg.vocab_size), out
    out["shared_kv"] = state["shared_kv"]
    positions = token_positions(b, s, pos, h.device)
    shared = params["shared"]

    def group_body(carry, xs):
        params_g, m_states, kv = xs
        x = _mamba_scan(params_g, cfg, carry, states=m_states)
        x, _ = _shared_block(shared, cfg, x, positions, cache=kv,
                             cache_pos=pos)
        return x, None

    h, _ = scan_util.scan(
        group_body, h, (_regroup(params["mamba_layers"], *group_dims(cfg)),
                        state["mamba"], state["shared_kv"]))
    return full_logits(unembed(params, cfg, h)[:, -1], cfg.vocab_size), out
