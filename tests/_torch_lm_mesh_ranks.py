"""Rank functions of the LM mesh tests (``tests/test_torch_lm_mesh*.py``).

Each runs in a process that ``repro_torch.launch.mesh.run_ranks`` spawned,
as ``fn(mesh, device, *args)``.  The parameters arrive as numpy trees (the
reference's, drawn by the test process) and reach the port through
``params_from_numpy``; what comes back is numpy.  This module imports
torch and the port only: the ranks never import jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import train as train_mod
from repro_torch.models.lm import get_model
from repro_torch.models.lm_params import params_from_numpy
from repro_torch.models.scan_util import tree_map

STEPS, BATCH, SEQ, LR = 2, 4, 32, 1e-3


def with_kw(cfg, kw: dict):
    """``cfg`` with the fields of ``kw`` replaced; a dict value replaces
    fields of the nested config it names (``{"moe": {"d_expert": 48}}``)."""
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in kw.items()})


def cfg_of(arch: str, kw: dict):
    return with_kw(configs.get_config(arch).reduced(), kw)


def train(cfg, np_params, mesh, device, **kw):
    """``train_loop`` from the given parameters; (losses, this rank's
    final local parameters as numpy)."""
    model = dataclasses.replace(
        get_model(cfg), init=lambda seed=0, device=None: params_from_numpy(
            np_params, device=device))
    final = {}
    make_step = train_mod.make_train_step

    def capture(model_, opt, plans=None):
        step = make_step(model_, opt, plans)

        def run(params, state, batch):
            out = step(params, state, batch)
            final["params"] = out[0]
            return out
        return run

    saved = train_mod.get_model, train_mod.make_train_step
    train_mod.get_model = lambda _cfg: model
    train_mod.make_train_step = capture
    try:
        args = dict(steps=STEPS, batch=BATCH, seq_len=SEQ, lr=LR,
                    log_every=0)
        args.update(kw)
        rep = train_mod.train_loop(cfg, mesh=mesh, device=device, **args)
    finally:
        train_mod.get_model, train_mod.make_train_step = saved
    local = tree_map(lambda t: t.detach().cpu().numpy(),
                     final.get("params", {}))
    return rep.losses, local


def train_ranks(mesh, device, cells: list, params: dict,
                ckpt_dir=None) -> dict:
    """``cells``: (name, arch, kw) trained on this mesh from
    ``params[name]`` (else ``params[arch]``); each result is (losses,
    local params).  With
    ``ckpt_dir`` (the (1, 2) mesh), gemma-2b also trains 3 steps, 2 steps
    with a checkpoint, and a resume to 3."""
    torch.set_num_threads(1)
    out = {}
    for name, arch, kw in cells:
        out[name] = train(cfg_of(arch, kw), params.get(name, params.get(
            arch)), mesh, device)
    if ckpt_dir is not None:
        cfg = cfg_of("gemma-2b", {})
        out["full3"] = train(cfg, params["gemma-2b"], mesh, device,
                             steps=3)[0]
        train(cfg, params["gemma-2b"], mesh, device, steps=2,
              ckpt_dir=ckpt_dir, ckpt_every=2)
        out["resumed"] = train(cfg, params["gemma-2b"], mesh, device,
                               steps=3, ckpt_dir=ckpt_dir, ckpt_every=100,
                               resume=True)[0]
    return out


def tp_ranks(mesh, device, cells: list, params: dict, ckpt_dir=None,
             resume: bool = False, layer_cases: list = ()) -> dict:
    """The enc-dec and recurrent families under tensor parallelism
    (``tests/test_torch_lm_mesh_tp.py``): ``cells`` as in
    :func:`train_ranks`; with ``ckpt_dir``, each cell's arch either trains
    3 steps uninterrupted and 2 with a checkpoint under ``ckpt_dir/name``
    (``resume`` False) or resumes from that checkpoint to step 3; then
    :func:`layer_ranks` of ``layer_cases``."""
    torch.set_num_threads(1)
    out = {"train": {}, "full3": {}, "resumed": {}}
    for name, arch, kw in cells:
        cfg, p = cfg_of(arch, kw), params[arch]
        out["train"][name] = train(cfg, p, mesh, device)
        if ckpt_dir is None:
            continue
        ck = f"{ckpt_dir}/{name}"
        if resume:
            out["resumed"][name] = train(cfg, p, mesh, device, steps=3,
                                         ckpt_dir=ck, ckpt_every=100,
                                         resume=True)[0]
        else:
            out["full3"][name] = train(cfg, p, mesh, device, steps=3)[0]
            train(cfg, p, mesh, device, steps=2, ckpt_dir=ck, ckpt_every=2)
    out["layers"] = layer_ranks(mesh, device, list(layer_cases))
    return out


def kept_pairs(top_aff, top_idx, offset: int = 0) -> np.ndarray:
    """The (token, expert) choices a routing kept, [n, 2] sorted: the
    slots of ``route``'s (top_aff, top_idx) [E_loc, C] that carry weight,
    experts numbered from ``offset``."""
    aff, idx = np.asarray(top_aff), np.asarray(top_idx)
    e, c = np.nonzero(aff != 0)
    pairs = np.stack([idx[e, c], e + offset], axis=1).astype(np.int64)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def moe_ranks(mesh, device, cfg, np_params: dict, x: np.ndarray,
              w: np.ndarray) -> dict:
    """One MoE layer on this mesh (expert parallel on model > 1 where the
    experts divide it, else the global batch): data rank d takes rows
    [d·B/D, (d+1)·B/D) of ``x`` [B, S, d]; returns its output rows, the
    gradients of ``sum(out · w)`` (this rank's blocks of the expert
    stacks, the router, and its rows of ``x``) and the (token, expert)
    choices its routing kept (:func:`kept_pairs`; tokens numbered in the
    rows it routed: its own, or the gathered global batch)."""
    from repro_torch.launch.sharding import use_mesh
    from repro_torch.models import moe
    from repro_torch.models.lm_params import shard_params
    torch.set_num_threads(1)
    kept = []
    route = moe.route

    def recorded(xt, router, cfg_, num_local_experts, expert_offset):
        top_aff, top_idx = route(xt, router, cfg_, num_local_experts,
                                 expert_offset)
        kept.append(kept_pairs(top_aff.detach().cpu(), top_idx.cpu(),
                               expert_offset))
        return top_aff, top_idx
    p, _ = shard_params(params_from_numpy(np_params, device=device), mesh,
                        cfg)
    n = x.shape[0] // mesh.shape["data"]
    rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)
    xt = torch.from_numpy(x[rows]).to(device).requires_grad_(True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()
              if isinstance(v, torch.Tensor)}
    moe.route = recorded
    try:
        with use_mesh(mesh):
            out = moe.moe_forward({**p, **leaves}, cfg, xt)
            loss = (out * torch.from_numpy(w[rows]).to(device)).sum()
            names = sorted(leaves)
            grads = torch.autograd.grad(loss,
                                        [leaves[k] for k in names] + [xt])
    finally:
        moe.route = route
    return {"out": out.detach().cpu().numpy(),
            "grads": {k: g.cpu().numpy() for k, g in zip(names + ["x"],
                                                         grads)},
            "kept": kept[0]}


def moe_mesh_ranks(mesh, device, cells: list, params: dict,
                   layer: tuple) -> dict:
    """The MoE module's world: ``train_ranks`` of ``cells``, then
    ``moe_ranks(*layer)`` (its config, parameters, input and weights)."""
    return {"train": train_ranks(mesh, device, cells, params),
            "layer": moe_ranks(mesh, device, *layer)}


def three_ranks(mesh, device, cells: list, params: dict, layer: tuple,
                hidden: tuple, attn_cases: list) -> dict:
    """A world whose model axis of 3 divides neither the experts nor the
    heads ((1, 3), ``tests/test_torch_lm_mesh_moe.py``; (2, 3),
    ``tests/test_torch_lm_mesh_six.py``): :func:`moe_mesh_ranks` of
    ``cells`` and ``layer``, ``moe_ranks(*hidden)``, then
    :func:`layer_ranks` of the MLA ``attn_cases``."""
    out = moe_mesh_ranks(mesh, device, cells, params, layer)
    out["hidden"] = moe_ranks(mesh, device, *hidden)
    out["attn"] = layer_ranks(mesh, device, attn_cases)
    return out


def ef_ranks(mesh, device, grads: list) -> list:
    """``ef_compress_update`` over the data group, one step per entry of
    ``grads`` (each a list of per-rank gradient trees), the residual
    carried; returns this rank's (decompressed grads, residual) per
    step."""
    from repro_torch.optim.compression import (ErrorFeedbackState,
                                               ef_compress_update)
    r = mesh.index("data")
    ef = ErrorFeedbackState.init(tree_map(torch.from_numpy, grads[0][r]))
    out = []
    for step in grads:
        g, ef = ef_compress_update(tree_map(torch.from_numpy, step[r]), ef,
                                   group=mesh.group("data"))
        out.append((tree_map(lambda t: t.numpy(), g),
                    tree_map(lambda t: t.numpy(), ef.residual)))
    return out


# ---------------------------------------------------------------------------
# one layer under tensor parallelism (tests/test_torch_lm_mesh_tp.py)
# ---------------------------------------------------------------------------

LAYER_B, LAYER_S, LAYER_S_ENC = 2, 32, 8


def layer_cfg(kind: str, heads: int):
    """The reduced config of a layer case with ``heads`` heads: seamless's
    cross-attention (its head width from d_model), zamba2's Mamba2 block
    (its head width from d_inner), xlstm's mLSTM / sLSTM cell, or
    deepseek's MLA (``mla``; ``mla-rows`` with ``v_head`` 24, which makes
    ``wo`` [heads·24, d] a row block on 3 ranks where 4·16 is whole)."""
    if kind in ("mla", "mla-rows"):
        return cfg_of("deepseek-v2-236b", {
            "num_heads": heads, "num_kv_heads": heads,
            "mla": {"v_head": 24 if kind == "mla-rows" else 16}})
    if kind == "cross":
        cfg = cfg_of("seamless-m4t-medium", {})
        return dataclasses.replace(cfg, num_heads=heads, num_kv_heads=heads,
                                   head_dim=cfg.d_model // heads)
    if kind == "mamba2":
        cfg = cfg_of("zamba2-2.7b", {})
        d_inner = cfg.ssm.expand * cfg.d_model
        return dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=d_inner // heads))
    cfg = cfg_of("xlstm-125m", {})
    return dataclasses.replace(cfg, xlstm=dataclasses.replace(
        cfg.xlstm, num_heads=heads))


def _layer(kind: str, cfg, seed: int):
    """(params, inputs, forward) of a layer case, drawn on the CPU from
    ``seed``: every leaf moved off its init (norm scales are zeros there)
    by noise, so every gradient is exercised."""
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    from repro_torch.models import xlstm as xl
    from repro_torch.models.common import make_generator
    from repro_torch.models.transformer import token_positions
    gen = make_generator(seed, "cpu")
    init = {"cross": lambda g: attn.init_attn(g, cfg, cross=True),
            "mla": lambda g: attn.init_attn(g, cfg),
            "mla-rows": lambda g: attn.init_attn(g, cfg),
            "mamba2": lambda g: ssm.init_ssm(g, cfg),
            "mlstm": lambda g: xl.init_mlstm(g, cfg),
            "slstm": lambda g: xl.init_slstm(g, cfg)}[kind]
    p = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
         for k, v in init(gen).items()}
    x = torch.randn((LAYER_B, LAYER_S, cfg.d_model), generator=gen)
    inputs = {"x": x}
    if kind == "cross":
        inputs["enc"] = torch.randn((LAYER_B, LAYER_S_ENC, cfg.d_model),
                                    generator=gen)
        pos = token_positions(LAYER_B, LAYER_S, 0, "cpu")

        def fwd(p, x, enc):
            kv = attn.make_cross_kv(p, cfg, enc)
            return attn.attn_forward(p, cfg, x, pos, cross_kv=kv)[0]
    elif kind.startswith("mla"):
        pos = token_positions(LAYER_B, LAYER_S, 0, "cpu")

        def fwd(p, x):
            return attn.attn_forward(p, cfg, x, pos)[0]
    else:
        cell = {"mamba2": ssm.ssm_forward, "mlstm": xl.mlstm_forward,
                "slstm": xl.slstm_forward}[kind]

        def fwd(p, x):
            return cell(p, cfg, x)[0]
    w = torch.randn((LAYER_B, LAYER_S, cfg.d_model), generator=gen)
    return p, inputs, fwd, w


def _layer_grads(fwd, p: dict, inputs: dict, w) -> tuple:
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    ins = {k: v.detach().clone().requires_grad_(True)
           for k, v in inputs.items()}
    out = fwd(leaves, **ins)
    names, xs = sorted(leaves), sorted(ins)
    grads = torch.autograd.grad((out * w).sum(),
                                [leaves[k] for k in names]
                                + [ins[k] for k in xs])
    g = dict(zip(names + xs, (t.numpy() for t in grads)))
    return out.detach().numpy(), g


def layer_ranks(mesh, device, cases: list) -> dict:
    """Each case (kind, heads, seed): the layer on one device (the mesh out
    of scope) and on this mesh from this rank's blocks of the same
    parameters; returns per case the one-device output and gradients
    (leaves sliced to this rank's blocks) beside the mesh's, and the ops
    of the collectives the mesh's forward and backward issued."""
    from repro_torch.launch.collectives import recording
    from repro_torch.launch.sharding import use_mesh
    from repro_torch.models.lm_params import shard_params
    torch.set_num_threads(1)
    out = {}
    for kind, heads, seed in cases:
        cfg = layer_cfg(kind, heads)
        p, inputs, fwd, w = _layer(kind, cfg, seed)
        one_out, one_g = _layer_grads(fwd, p, inputs, w)
        local, plans = shard_params(p, mesh, cfg)
        for k, plan in plans.items():
            one_g[k] = plan.local(torch.from_numpy(one_g[k])).numpy()
        with use_mesh(mesh), recording() as log:
            got_out, got_g = _layer_grads(fwd, local, inputs, w)
        out[f"{kind}/{heads}"] = {
            "one": (one_out, one_g), "mesh": (got_out, got_g),
            "split": sorted(k for k, pl in plans.items() if pl.axes),
            "collectives": [e["op"] for e in log]}
    return out
