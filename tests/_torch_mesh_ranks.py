"""Rank functions of the mesh tests (``tests/test_torch_mesh_*.py``).

Each runs in a process that ``repro_torch.launch.mesh.run_ranks`` spawned,
as ``fn(mesh, device, *args)``, and returns numpy arrays.  This module
imports torch and the port only: the ranks never import jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


def _t(a, device, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t.requires_grad_(True) if grad else t


def _shard(table, mesh, axis="model"):
    rps = table.shape[0] // mesh.shape[axis]
    m = mesh.index(axis)
    return table[m * rps:(m + 1) * rps]


# ---------------------------------------------------------------------------
# the sharded ops (test_torch_mesh_ops.py)
# ---------------------------------------------------------------------------

def _lookup(case, mesh, device, g, **kw):
    """The port's sharded K1 on this rank's group ``g`` of ``case``."""
    return ops.cache_lookup_agg(
        _t(_shard(case["table"], mesh), device),
        _t(case["streamed"][g], device), _t(case["slots"][g], device),
        _t(case["idx"][g], device), _t(case["w"][g], device),
        mesh=mesh, shard_axis="model", **kw).cpu().numpy()


def ops_ranks(mesh4, device, cases: dict) -> dict:
    """Every forward path at 1x4 and 2x2, the 2x2 gradients, and K3's
    mesh branch at 1x4; ``cases`` as ``test_torch_mesh_ops._cases``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sampling.adjacency import DeviceCacheAdj
    from repro_torch.sampling.kernels import gns_sample_agg
    torch.set_num_threads(1)
    out = {}
    for name, mesh in (("1x4", mesh4), ("2x2", make_host_mesh(2, 2))):
        case = cases[name]
        g = mesh.index("data")
        out[f"{name}/psum"] = _lookup(case, mesh, device, g)
        ls = case["local_shard"]
        out[f"{name}/static"] = _lookup(dict(case, slots=case["slots_ls"]),
                                        mesh, device, g, local_shard=ls)
        homes = case["local_shards"]
        out[f"{name}/dynamic"] = _lookup(
            dict(case, slots=case["slots_dyn"]), mesh, device, g,
            local_shards=homes)
        out[f"{name}/dynamic_off"] = _lookup(
            case, mesh, device, g, local_shards=np.full_like(homes, -1))
    # gradients at 2x2: the psum path, and the static one against the psum
    # path on the static one's slots (one backward)
    case = cases["2x2"]
    g = mesh.index("data")
    for path, kw, slots in (("psum", {}, case["slots"]),
                            ("static", {"local_shard": case["local_shard"]},
                             case["slots_ls"]),
                            ("psum_ls", {}, case["slots_ls"])):
        tbl = _t(_shard(case["table"], mesh), device, grad=True)
        st = _t(case["streamed"][g], device, grad=True)
        w = _t(case["w"][g], device, grad=True)
        o = ops.cache_lookup_agg(tbl, st, _t(slots[g], device),
                                 _t(case["idx"][g], device), w, mesh=mesh,
                                 shard_axis="model", **kw)
        (o ** 2).sum().backward()
        out[f"grad/{path}/table"] = tbl.grad.cpu().numpy()
        out[f"grad/{path}/streamed"] = st.grad.cpu().numpy()
        out[f"grad/{path}/w"] = w.grad.cpu().numpy()
    # K3's mesh branch at 1x4: each shard's row range, all-reduced
    for name in ("k3_exact", "k3_rand"):
        k3 = cases[name]
        adj = DeviceCacheAdj(*(_t(k3[f], device) for f in
                               ("indptr", "indices", "deg", "hitp")))
        out[name] = gns_sample_agg(
            adj, _t(_shard(k3["table"], mesh4), device),
            _t(k3["dst"], device), _t(k3["fb_rows"], device),
            _t(k3["fb_w"], device), k3["key"], mesh=mesh4,
            shard_axis="model").cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# the engine (test_torch_mesh_engine.py)
# ---------------------------------------------------------------------------

def engine_config(spec: dict):
    """The small engine config of the engine tests: dataset ``tiny`` at
    ``spec["scale"]``, ``spec``'s sampler backend, input impl, cache
    policy, placement and refresh mode, 2 layers of width 16."""
    from repro_torch.featurestore import CacheConfig
    from repro_torch.gns import EngineConfig, ModelConfig
    from repro_torch.gns.config import DataConfig, MeshConfig
    from repro_torch.core.sampler import SamplerConfig
    return EngineConfig(
        sampler="gns", seed=spec.get("seed", 0),
        data=DataConfig(name="tiny", scale=spec.get("scale", 1.0)),
        sampling=SamplerConfig(batch_size=spec.get("batch", 64),
                               fanouts=(3, 4),
                               backend=spec.get("backend", "host")),
        cache=CacheConfig(fraction=0.1,
                          strategy=spec.get("strategy", "auto"),
                          placement=spec.get("placement", "contiguous"),
                          async_refresh=spec.get("async", False)),
        model=ModelConfig(hidden_dim=16,
                          input_impl=spec.get("input", "fused")),
        mesh=MeshConfig(*spec["mesh"]) if "mesh" in spec else None)


def params_numpy(engine) -> list:
    return [t.detach().cpu().numpy() for layer in engine.params["layers"]
            for t in layer.values()]


def generation_numpy(engine) -> dict:
    gen = engine.store.generation
    pm = gen.state.placement
    return {"node_ids": np.asarray(gen.state.node_ids),
            "placement": (None if pm is None
                          else np.asarray(pm.device_row_of_slot)),
            "version": gen.version, "table": gen.table.cpu().numpy()}


def _fit(spec, mesh, device) -> dict:
    from repro_torch.gns import GNSEngine
    eng = GNSEngine(engine_config(spec), device=device, mesh=mesh)
    rep = eng.fit(spec.get("epochs", 1), max_batches=spec.get("steps"),
                  prefetch=spec.get("prefetch", False))
    out = {"losses": rep.losses, "params": params_numpy(eng),
           "describe": eng.describe().get("mesh"),
           "upload": eng.meter.bytes_cache_upload,
           "uploads": eng.meter.uploads, "swaps": eng.store.swaps,
           "generation": generation_numpy(eng)}
    if spec.get("eval"):
        out["val_acc"] = eng.evaluate(num_batches=1)
        out["infer"] = eng.infer(eng.ds.val_idx[:20])
    return eng, out


def engine_ranks(_world, device, specs: list) -> list:
    """``fit`` (and, where a spec asks, ``evaluate`` and ``infer``) of each
    spec on the mesh it names, built over this world's process group."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    outs = []
    for spec in specs:
        outs.append(_fit(spec, make_host_mesh(*spec["mesh"]), device)[1])
    return outs


def locality_ranks(mesh, device, spec: dict) -> dict:
    """The 2x2 engine with locality placement: train an epoch (every
    group's requests reach every rank's store at the next kickoff), then
    refresh; the generations of all ranks must agree."""
    torch.set_num_threads(1)
    eng, out = _fit(spec, mesh, device)
    eng.sampler.refresh_cache(np.random.default_rng(5), version=7)
    out["refreshed"] = generation_numpy(eng)
    out["group_hist"] = {g: h.copy()
                         for g, h in eng.meter.group_hist.items()}
    return out


def raise_on_rank_1(mesh, device) -> None:
    """The launcher's failure path: rank 1 raises, rank 0 returns."""
    if mesh.rank == 1:
        raise ValueError("rank 1 raises on purpose")
