"""Rank functions of the dry-run and mesh-serving tests
(``tests/test_torch_dryrun.py``, ``tests/test_torch_mesh_serve_lm.py``).

Each runs in a process that ``repro_torch.launch.mesh.run_ranks`` spawned,
as ``fn(mesh, device, *args)``, and imports torch and the port only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.sharding import map_with_path

SHAPES = {"train": ShapeSpec("t", 32, 8, "train"),
          "decode": ShapeSpec("d", 32, 8, "decode"),
          "prefill": ShapeSpec("p", 32, 8, "prefill")}


def count_cells(mesh, device, cells: list) -> dict:
    """``cells``: (arch, kind) counted on this real rank, on zeros of the
    local shapes: {cell: (flops, bytes, peak bytes, [(op, bytes, group,
    site), ...])}."""
    from repro_torch.launch.dryrun import cell_step, count_step
    from repro_torch.launch.sharding import arch_scope
    torch.set_num_threads(1)
    out = {}
    for arch, kind in cells:
        cfg = configs.get_config(arch).reduced()
        with arch_scope(cfg):
            run = cell_step(cfg, SHAPES[kind], mesh, "float32",
                             device=device)[0]
            counter, log = count_step(run, mesh)
        out[(arch, kind)] = (counter.flops, counter.bytes,
                             counter.peak_bytes,
                             [(r["op"], r["bytes"], r["group"], r["site"])
                              for r in log])
    return out


def _flat(tree) -> dict:
    out = {}

    def one(path, x):
        if isinstance(x, torch.Tensor):
            out[path] = x.float().cpu().numpy()
        return x
    map_with_path(one, tree)
    return out


def serve_cells(mesh, device, cells: list, params: dict, batch: dict
                ) -> dict:
    """``cells``: (name, arch, new tokens, cache len), served greedily on
    this rank from ``params[arch]`` (the reference's, numpy) with
    ``batch[name]`` = (prompts, frames or None): {name: (tokens [B_local,
    n], logits per step, this rank's final state as {path: array}, the
    layout, the next tokens of prefill_step and of one serve_step after
    it [B_local, 2])}."""
    from repro_torch.launch.serve import mesh_generate, mesh_state
    from repro_torch.launch.sharding import (ShardPlan, spec_for,
                                            use_mesh)
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, mesh_layout)
    from repro_torch.models import encdec
    from repro_torch.models.lm import get_model
    from repro_torch.models.lm_params import params_from_numpy, shard_params
    torch.set_num_threads(1)
    out = {}
    for name, arch, n, cache_len in cells:
        cfg = configs.get_config(arch).reduced()
        full = params_from_numpy(params[arch], device=device)
        local, plans = shard_params(full, mesh, cfg)
        prompts, frames = batch[name]
        gen = mesh_generate(cfg, local, plans, mesh, prompts, n,
                            frame_embeds=frames, cache_len=cache_len,
                            device=device, keep_logits=True)
        # prefill_step on a fresh state (the enc-dec one with its cross
        # K/V from this rank's rows and heads of the encoder; these cells
        # leave the encoder's slots whole)
        b, s = prompts.shape
        enc = 0 if frames is None else frames.shape[1]
        fresh, s_plans = mesh_state(cfg, mesh, b, cache_len, enc, device)
        t_plan = ShardPlan(mesh, spec_for(mesh, ("batch", None), (b, s)),
                           (b, s))
        lay = mesh_layout(t_plan, s_plans)
        step = make_prefill_step(get_model(cfg), plans, lay)
        serve = make_serve_step(get_model(cfg), plans, lay)
        with use_mesh(mesh), torch.inference_mode():
            if frames is not None:
                f_plan = ShardPlan(mesh, spec_for(
                    mesh, ("batch", None, None), frames.shape),
                    frames.shape)
                fresh["cross"] = encdec.prefill_encoder(
                    local, cfg, f_plan.local(torch.as_tensor(frames)))
            nxt, fresh = step(local, t_plan.local(
                torch.as_tensor(prompts)), fresh)
            nxt2, _ = serve(local, nxt, fresh)
        out[name] = (gen.tokens, gen.logits, _flat(gen.state), gen.layout,
                     np.concatenate([nxt.cpu().numpy(), nxt2.cpu().numpy()],
                                    axis=1))
    return out



def describe_engine(mesh, device) -> dict:
    """``GNSEngine.describe()`` of the tiny dataset's engine on this
    rank."""
    import dataclasses as dc

    from repro_torch.gns import EngineConfig, GNSEngine
    from repro_torch.gns.config import DataConfig, MeshConfig
    torch.set_num_threads(1)
    cfg = dc.replace(EngineConfig.preset("quickstart"),
                     data=DataConfig(name="tiny", scale=1.0),
                     mesh=MeshConfig(data=mesh.data, model=mesh.model))
    return GNSEngine(cfg, device=device).describe()
