"""xLSTM language-model assembly, xlstm-125m (port of
``repro.models.xlstm_lm``).

Block pattern: mostly mLSTM with sLSTM at ``cfg.xlstm.slstm_at``, held as
consecutive same-kind *runs*, each run a layer loop over stacked params
(the reference's layout: one ``[n, ...]`` stack per run).

Every block is pre-norm residual: ``h = h + block(rms_norm(h))``.
``cfg.remat`` runs each block of a training forward under
``torch.utils.checkpoint``.  Decode state is O(1) per layer (mLSTM matrix
memory, sLSTM scalar cells), one real allocation per layer, updated in
place; ``pos`` is a Python int.

On a mesh's model axis (training), the cells run their heads
(``models/xlstm.py``) and the tied table is split by vocab rows (a masked
lookup summed over the group; the logits this rank's vocab slice,
reduced by the vocab-parallel cross-entropy).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import scan_util
from repro_torch.models import xlstm as xl
from repro_torch.models.common import (cross_entropy, embed_init,
                                       full_logits, model_dtype, rms_norm,
                                       stack_init, zeros)
from repro_torch.models.transformer import embed_tokens, unembed


def layer_runs(cfg: ArchConfig) -> list[tuple[str, int, str]]:
    """[(group_name, count, kind)]: consecutive same-kind runs."""
    slstm = set(cfg.xlstm.slstm_at)
    kinds = ["slstm" if i in slstm else "mlstm" for i in range(cfg.num_layers)]
    runs, start = [], 0
    for i in range(1, cfg.num_layers + 1):
        if i == cfg.num_layers or kinds[i] != kinds[start]:
            runs.append((f"run{len(runs)}_{kinds[start]}", i - start,
                         kinds[start]))
            start = i
    return runs


def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    init = xl.init_mlstm if kind == "mlstm" else xl.init_slstm
    return {"norm": zeros(gen, (cfg.d_model,)), "cell": init(gen, cfg)}


def init_xlstm_lm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters in the reference's layout, on ``gen``'s device."""
    dt = model_dtype(cfg)
    in_key = "embed" if cfg.tie_embeddings else "embed_in"
    params = {
        in_key: embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": zeros(gen, (cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.d_model, cfg.vocab_size, dt)
    for name, n, kind in layer_runs(cfg):
        params[name] = stack_init(
            gen, n, lambda g, kind=kind: _init_block(g, cfg, kind))
    return params


def _scan_run(params_r, cfg: ArchConfig, h, kind: str, states=None):
    fwd = xl.mlstm_forward if kind == "mlstm" else xl.slstm_forward
    if states is None:
        def body(carry, bp):
            out, _ = fwd(bp["cell"], cfg, rms_norm(carry, bp["norm"]))
            return carry + out, None

        return scan_util.scan(body, h, params_r, remat=cfg.remat)[0]

    def decode_body(carry, xs):
        bp, st = xs
        out, _ = fwd(bp["cell"], cfg, rms_norm(carry, bp["norm"]), state=st)
        return carry + out, None                  # st updated in place

    return scan_util.scan(decode_body, h, (params_r, states))[0]


def xlstm_forward(params: dict, cfg: ArchConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    h = embed_tokens(params, cfg, tokens)
    for name, _, kind in layer_runs(cfg):
        h = _scan_run(params[name], cfg, h, kind)
    return unembed(params, cfg, h)


def xlstm_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Next-token CE (plain; ``chunked_ce`` does not apply, as in the
    reference)."""
    tokens = batch["tokens"]
    logits = xlstm_forward(params, cfg, tokens)
    return cross_entropy(logits[:, :-1], tokens[:, 1:],
                         vocab=cfg.vocab_size)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, *, device) -> dict:
    """Per run, its blocks' zero states stacked ``[n, ...]`` (``repeat``:
    a tensor of its own, never a broadcast view)."""
    groups = {}
    for name, n, kind in layer_runs(cfg):
        init = xl.init_mlstm_state if kind == "mlstm" else xl.init_slstm_state
        groups[name] = scan_util.tree_map(
            lambda x, n=n: x.repeat(n, *([1] * x.dim())),
            init(cfg, batch, device=device))
    return {"states": groups, "pos": 0}


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                state: dict) -> tuple[torch.Tensor, dict]:
    """tokens [B, S_new] -> (logits of the last position [B, V], state
    with pos + S_new; its tensors updated in place)."""
    h = embed_tokens(params, cfg, tokens)
    for name, _, kind in layer_runs(cfg):
        h = _scan_run(params[name], cfg, h, kind,
                      states=state["states"][name])
    logits = full_logits(unembed(params, cfg, h)[:, -1], cfg.vocab_size)
    return logits, {"states": state["states"],
                           "pos": state["pos"] + tokens.shape[1]}
