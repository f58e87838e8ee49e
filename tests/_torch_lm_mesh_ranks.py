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


def cfg_of(arch: str, kw: dict):
    return dataclasses.replace(configs.get_config(arch).reduced(), **kw)


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


def moe_ranks(mesh, device, cfg, np_params: dict, x: np.ndarray,
              w: np.ndarray) -> dict:
    """One MoE layer on this mesh (expert parallel on model > 1, the
    global batch on a data axis alone): data rank d takes rows
    [d·B/D, (d+1)·B/D) of ``x`` [B, S, d]; returns its output rows and
    the gradients of ``sum(out · w)`` (this rank's blocks of the expert
    stacks, the router, and its rows of ``x``)."""
    from repro_torch.launch.sharding import use_mesh
    from repro_torch.models import moe
    from repro_torch.models.lm_params import shard_params
    torch.set_num_threads(1)
    p, _ = shard_params(params_from_numpy(np_params, device=device), mesh,
                        cfg)
    n = x.shape[0] // mesh.shape["data"]
    rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)
    xt = torch.from_numpy(x[rows]).to(device).requires_grad_(True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()
              if isinstance(v, torch.Tensor)}
    with use_mesh(mesh):
        out = moe.moe_forward({**p, **leaves}, cfg, xt)
        loss = (out * torch.from_numpy(w[rows]).to(device)).sum()
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [xt])
    return {"out": out.detach().cpu().numpy(),
            "grads": {k: g.cpu().numpy() for k, g in zip(names + ["x"],
                                                         grads)}}


def moe_mesh_ranks(mesh, device, cells: list, params: dict,
                   layer: tuple) -> dict:
    """The MoE module's world: ``train_ranks`` of ``cells``, then
    ``moe_ranks(*layer)`` (its config, parameters, input and weights)."""
    return {"train": train_ranks(mesh, device, cells, params),
            "layer": moe_ranks(mesh, device, *layer)}


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
