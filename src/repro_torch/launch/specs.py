"""Batch, decode-state, parameter and optimizer plans for the mesh
trainer (port of ``repro.launch.specs``).

The reference builds ``ShapeDtypeStruct`` stand-ins and ``NamedSharding``
trees for its dry-run and launchers.  Here a stand-in is a tensor on the
``meta`` device (a shape and a dtype, no storage) and a sharding is a
:class:`~repro_torch.launch.sharding.ShardPlan`; the rules are the
reference's.

Decode state rules (leaf name + trailing rank; leading stacked-layer dims
replicate):

  k/v        [L,B,Hkv,S,Dh] -> (None, batch, model, seq, None)
  slot_pos   [L,W]          -> replicated (tiny)
  c_kv       [L,B,S,lora]   -> (None, batch, seq, None)     (MLA latent)
  k_rope     [L,B,S,rope]   -> (None, batch, seq, None)
  conv       [.,B,K,C]      -> (batch, None, model)          (Mamba2)
  ssd        [.,B,H,P,N]    -> (batch, model, None, None)
  mLSTM c/n/m, sLSTM h/c/n/m -> batch + heads-on-model

'batch' resolves to ('pod','data') and 'seq' to 'data'; each mesh axis
shards at most one dim, so decode_32k (B=128) shards the batch over
pod×data and replicates seq, while long_500k (B=1) shards the 500k-token
cache over 'data' instead.  Axes that do not divide replicate.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.launch.sharding import (ShardPlan, map_with_path, spec_for,
                                        tree_param_shardings)
from repro_torch.models.lm import ModelAPI, enc_dec_split, get_model
from repro_torch.models.scan_util import tree_map


def _struct(shape: tuple, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# batch structs
# ---------------------------------------------------------------------------

def train_batch_structs(cfg, shape) -> dict:
    """The family's training batch, as ``meta`` tensors of ``[B, ...]``."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.encoder_layers > 0:
        s_enc, s_dec = enc_dec_split(cfg, s)
        return {"frame_embeds": _struct((b, s_enc, cfg.d_model)),
                "tokens": _struct((b, s_dec), torch.int32)}
    if cfg.frontend == "vision":
        p = min(cfg.frontend_tokens, max(s - 1, 1))
        return {"patch_embeds": _struct((b, p, cfg.d_model)),
                "tokens": _struct((b, s - p), torch.int32)}
    return {"tokens": _struct((b, s), torch.int32)}


def batch_shardings(mesh, structs: dict, accum_dim: bool = False) -> dict:
    """Batch leaves shard on the batch dim; a leading [accum] microbatch
    dim (the train_step layout, ``launch/steps.py``) is replicated."""
    out = {}
    for name, sd in structs.items():
        lead = (None,) if accum_dim else ()
        axes = lead + ("batch",) + (None,) * (len(sd.shape) - len(lead) - 1)
        out[name] = ShardPlan(mesh, spec_for(mesh, axes, sd.shape), sd.shape)
    return out


# ---------------------------------------------------------------------------
# decode state structs
# ---------------------------------------------------------------------------

def decode_state_structs(model: ModelAPI, shape) -> Any:
    """The decode state of ``shape``'s batch and length, on the ``meta``
    device (no storage: the 500k-token caches too)."""
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    if cfg.encoder_layers > 0:
        enc_len, _ = enc_dec_split(cfg, s)
        return model.decode_init(b, s, enc_len, device="meta")
    if cfg.xlstm is not None:
        return model.decode_init(b, device="meta")
    return model.decode_init(b, s, device="meta")


# leaf name -> trailing logical axes, right-aligned; leading stacked dims None
_STATE_RULES: dict[str, tuple] = {
    "k": ("batch", "model", "seq", None),
    "v": ("batch", "model", "seq", None),
    "c_kv": ("batch", "seq", None),
    "k_rope": ("batch", "seq", None),
    "conv": ("batch", None, "model"),
    "ssd": ("batch", "model", None, None),
}
# per-layer ranks of the xLSTM cell states (run-stacked leaves add 1):
_MLSTM_RULES = {"c": ("batch", "model", None, None),
                "n": ("batch", "model", None), "m": ("batch", "model")}
_SLSTM_RULES = {"h": ("batch", "model", None), "c": ("batch", "model", None),
                "n": ("batch", "model", None), "m": ("batch", "model", None)}


def _state_axes(path: str, shape) -> tuple:
    leaf = path.split("/")[-1]
    if "mlstm" in path:
        rule = _MLSTM_RULES.get(leaf)
    elif "slstm" in path:
        rule = _SLSTM_RULES.get(leaf)
    else:
        rule = _STATE_RULES.get(leaf)
    if rule is None or len(rule) > len(shape):
        return (None,) * len(shape)
    return (None,) * (len(shape) - len(rule)) + rule


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def state_shardings(mesh, state_structs) -> Any:
    """A plan per leaf of a decode state (a Python int, the position, is
    a replicated scalar)."""
    def one(path, sd):
        shape = _shape(sd)
        return ShardPlan(mesh, spec_for(mesh, _state_axes(path, shape),
                                        shape), shape)
    return map_with_path(one, state_structs)


# ---------------------------------------------------------------------------
# params / optimizer
# ---------------------------------------------------------------------------

def param_structs(model: ModelAPI):
    """The parameter tree at the config's published shapes and dtypes, as
    ``meta`` tensors (the reference's ``eval_shape`` of ``init``): the
    family's init on ``meta``, which draws nothing."""
    return model.init(0, device="meta")


def local_structs(structs, plans, device="meta"):
    """Tensors of each leaf's local shape under its plan: ``meta`` ones,
    or zeros on ``device`` (a non-tensor leaf, the decode position or the
    step count, passes)."""
    def one(plan, x):
        if not isinstance(x, torch.Tensor):
            return x
        if torch.device(device).type == "meta":
            return torch.empty(plan.local_shape, dtype=x.dtype,
                               device="meta")
        return torch.zeros(plan.local_shape, dtype=x.dtype, device=device)
    return tree_map(one, plans, structs)


def param_shardings(mesh, structs, cfg):
    """A plan per parameter leaf (rule table; ``cfg.fsdp``: ZeRO-3)."""
    return tree_param_shardings(mesh, structs, fsdp=cfg.fsdp)


def opt_state_shardings(mesh, opt_structs, params_shardings) -> dict:
    """Adam moments follow their parameter's plan; the step is a
    replicated scalar."""
    return {"m": params_shardings, "v": params_shardings,
            "step": ShardPlan(mesh, spec_for(mesh, (), ()), ())}


# ---------------------------------------------------------------------------
# top-level: everything the dry-run needs for one (arch x shape)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape, mesh, model: Optional[ModelAPI] = None) -> dict:
    """Structs and plans for one dry-run cell, each ``(structs, plans)``.

    kind == train:  {params, batch} for train_step (the batch with its
                    leading [accum] dim; the optimizer's moments follow
                    the parameters' plans, ``opt_state_shardings``).
    kind == decode / prefill: {params, tokens, state} for serve_step /
                    prefill_step (the enc-dec prompt is the decoder's
                    share of the sequence).
    """
    model = model or get_model(cfg)
    p_structs = param_structs(model)
    out = {"params": (p_structs, param_shardings(mesh, p_structs, cfg))}
    if shape.kind in ("decode", "prefill"):
        if shape.kind == "decode":
            s_new = 1
        elif cfg.encoder_layers > 0:       # enc-dec: prompt = decoder share
            _, s_new = enc_dec_split(cfg, shape.seq_len)
        else:
            s_new = shape.seq_len
        t_shape = (shape.global_batch, s_new)
        t_struct = _struct(t_shape, torch.int32)
        out["tokens"] = (t_struct, ShardPlan(
            mesh, spec_for(mesh, ("batch", None), t_shape), t_shape))
        s_structs = decode_state_structs(model, shape)
        out["state"] = (s_structs, state_shardings(mesh, s_structs))
    else:
        from repro_torch.launch.steps import add_accum_dim
        b_structs = add_accum_dim(cfg, train_batch_structs(cfg, shape))
        out["batch"] = (b_structs, batch_shardings(mesh, b_structs,
                                                   accum_dim=True))
    return out
