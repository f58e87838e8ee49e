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


# ---------------------------------------------------------------------------
# serving, the fabric, ingest and checkpoints on a mesh
# (test_torch_mesh_{serve,fabric,stream}.py)
# ---------------------------------------------------------------------------

WAIT_S = 120.0         # bound of every wait in a rank


def wait_until(pred, what: str, timeout: float = WAIT_S) -> None:
    import time
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s: {what}")
        time.sleep(0.01)


def mesh_engine(text: str, mesh, device, params=None):
    """The port's engine of a reference config (JSON) on ``mesh``, with
    the reference's parameters (a numpy tree) when given."""
    import json
    from repro_torch.gns import EngineConfig, GNSEngine
    from repro_torch.models.graphsage import params_from_numpy
    eng = GNSEngine(EngineConfig.from_dict(json.loads(text)), device=device,
                    mesh=mesh)
    if params is not None:
        eng.params = params_from_numpy(params, device=device)
    return eng


def record_batches(engine) -> list:
    """Wrap ``engine.infer_compute`` to log ``(thread name, pinned version,
    logits)`` of every batch this rank computes."""
    import threading
    log = []
    compute = engine.infer_compute

    def recorded(mb, meter=None, mesh=None):
        out = compute(mb, meter=meter, mesh=mesh)
        log.append((threading.current_thread().name, mb.cache_version,
                    out.copy()))
        return out

    engine.infer_compute = recorded
    return log


def refuses(call, error) -> bool:
    try:
        call()
    except error:
        return True
    return False


def store_state(engine) -> dict:
    """The store's live generation and what the next build reads."""
    store = engine.store
    out = generation_numpy(engine)
    out["ema"] = getattr(store.policy, "_ema", None)
    out["ema"] = None if out["ema"] is None else out["ema"].copy()
    out["group_hist"] = {g: h.copy()
                         for g, h in store.meter.group_hist.items()}
    return out


def serve_ranks(mesh, device, spec: dict) -> dict:
    """GNSServer on this mesh: (1) ``spec["requests"]`` one at a time on
    the leader, every rank's batches logged, a follower's ``submit``
    refused; the store's counts, then a synchronous refresh; (2) the
    reference's serve smoke: a skewed stream with serving-driven
    refreshes."""
    from repro_torch.launch.mesh import NotLeader
    torch.set_num_threads(1)
    out = {"rank": mesh.rank}
    eng = mesh_engine(spec["cfg"], mesh, device, spec["params"])
    log = record_batches(eng)
    results = []
    with eng.serve() as srv:
        if mesh.leader:
            for ids in spec["requests"]:
                r = srv.submit(ids).result(timeout=WAIT_S)
                results.append((r.status, r.bucket, r.cache_version,
                                r.logits))
            out["served"] = srv.meter.snapshot()["served"]
        else:
            out["refused"] = refuses(lambda: srv.submit(np.arange(3)),
                                     NotLeader)
    out["results"] = results
    out["log"] = [(v, x) for _, v, x in log]
    out["counted"] = store_state(eng)
    eng.store.refresh(np.random.default_rng(5), version=1)
    out["refreshed"] = store_state(eng)

    # (2) the smoke
    eng = mesh_engine(spec["smoke_cfg"], mesh, device)
    log = record_batches(eng)
    rng = np.random.default_rng(7)
    hot = rng.choice(eng.ds.val_idx, size=40, replace=False)
    with eng.serve() as srv:
        if mesh.leader:
            for _ in range(60):
                pool = hot if rng.random() < 0.85 else eng.ds.val_idx
                ids = rng.choice(pool, size=int(rng.integers(2, 8)),
                                 replace=False)
                srv.infer(ids, timeout=WAIT_S)
    eng.store.wait_refresh(timeout=WAIT_S)     # every rank: an agreement
    m = srv.meter
    out["smoke"] = {"snapshot": m.snapshot(), "trail": m.generation_trail(),
                    "traj": m.hit_trajectory(),
                    "swaps": m.swaps_observed,
                    "versions": [v for _, v, _ in log],
                    "logits": [x for _, _, x in log],
                    "generation": generation_numpy(eng)}
    return out


def fabric_ranks(mesh, device, spec: dict) -> dict:
    """ServeFabric on this mesh: (1) ``spec["pinned"]`` requests, each
    pinned to a worker, one at a time; (2) concurrent traffic with a
    refresh every 2 batches, then every rank's generation; (3) the
    reference's fabric smoke: two tenants, a killed worker."""
    import time
    from repro_torch.gns import FabricConfig, TenantConfig
    from repro_torch.launch.mesh import NotLeader
    torch.set_num_threads(1)
    out = {"rank": mesh.rank}

    def worker_logs(log):
        by = {}
        for name, v, x in log:
            by.setdefault(name, []).append((v, x))
        return by

    # (1) pinned requests against the reference fabric
    eng = mesh_engine(spec["cfg"], mesh, device, spec["params"])
    log = record_batches(eng)
    fab = eng.serve_fabric(FabricConfig(workers=2, stall_timeout_ms=600_000.0,
                                        watch_interval_ms=50.0))
    results = []
    with fab:
        if mesh.leader:
            for w, ids in spec["pinned"]:
                r = fab.submit(ids, worker=w).result(timeout=WAIT_S)
                results.append((r.status, r.bucket, r.cache_version,
                                r.logits))
            snap = fab.meter.snapshot()
            out["pinned_errors"] = (snap["errors"], fab.fabric_error)
        else:
            out["refused"] = refuses(lambda: fab.submit(np.arange(3)),
                                     NotLeader)
    out["pinned"] = results
    out["pinned_log"] = worker_logs(log)

    # (2) two workers under concurrent traffic, a refresh every 2 batches
    eng = mesh_engine(spec["refresh_cfg"], mesh, device)
    log = record_batches(eng)
    fab = eng.serve_fabric(FabricConfig(workers=2, stall_timeout_ms=600_000.0,
                                        watch_interval_ms=50.0))
    rng = np.random.default_rng(11)
    with fab:
        if mesh.leader:
            # a stream of requests, so that swaps land while batches are in
            # flight on the workers
            futs = []
            for _ in range(16):
                futs += [fab.submit(rng.choice(eng.ds.val_idx,
                                               int(rng.integers(2, 12)),
                                               replace=False))
                         for _ in range(3)]
                time.sleep(0.03)
            out["refresh_status"] = [f.result(timeout=WAIT_S).status
                                     for f in futs]
            wait_until(lambda: fab.meter.snapshot()["swaps_observed"] >= 2,
                       "two serving-driven swaps")
            out["refresh_snapshot"] = fab.meter.snapshot()
    eng.store.wait_refresh(timeout=WAIT_S)
    out["refresh_log"] = worker_logs(log)
    out["refresh_generation"] = generation_numpy(eng)
    out["refresh_errors"] = fab.fabric_error

    # (2b) a swap while a batch is in flight: worker 0 stalls between
    # sampling its batch and sending it, and the refresh that the batch
    # before it made due swaps in meanwhile
    eng = mesh_engine(spec["refresh_cfg"].replace('"refresh_every": 2',
                                                  '"refresh_every": 1'),
                      mesh, device)
    log = record_batches(eng)
    fab = eng.serve_fabric(FabricConfig(workers=2, stall_timeout_ms=600_000.0,
                                        watch_interval_ms=20.0))
    with fab:
        if mesh.leader:
            ids = eng.ds.val_idx[:6]
            first = fab.submit(ids, worker=1).result(timeout=WAIT_S)
            fab.workers[0].stall_s = 0.6
            stalled = fab.submit(ids, worker=0).result(timeout=WAIT_S)
            fab.workers[0].stall_s = 0.0
            out["stall"] = {"first": first.cache_version,
                            "stalled": stalled.cache_version,
                            "swaps": fab.meter.snapshot()["swaps_observed"],
                            "live": eng.store.version}
    eng.store.wait_refresh(timeout=WAIT_S)
    out["stall_log"] = worker_logs(log)
    out["stall_errors"] = fab.fabric_error

    # (3) the reference's fabric smoke
    eng = mesh_engine(spec["smoke_cfg"], mesh, device)
    ds = eng.ds
    fab = eng.serve_fabric(FabricConfig(
        workers=2,
        tenants=(TenantConfig("mobile", weight=2.0, max_queue=64),
                 TenantConfig("batch", weight=1.0, max_queue=64)),
        stall_timeout_ms=10_000.0, watch_interval_ms=50.0))
    rng = np.random.default_rng(7)
    half = len(ds.val_idx) // 2
    hot_a = rng.choice(ds.val_idx[:half], size=30, replace=False)
    hot_b = rng.choice(ds.val_idx[half:], size=30, replace=False)
    with fab:
        if mesh.leader:
            futs = []
            for i in range(60):
                tenant, hot = (("mobile", hot_a) if i % 2 == 0
                               else ("batch", hot_b))
                ids = rng.choice(hot, size=int(rng.integers(2, 8)),
                                 replace=False)
                futs.append(fab.submit(ids, tenant=tenant))
            status = [f.result(timeout=WAIT_S).status for f in futs]
            fab.workers[0].kill()
            fut = fab.submit(rng.choice(hot_a, size=4, replace=False),
                             tenant="mobile", worker=0)
            wait_until(lambda: not fab.workers[0].alive(),
                       "the killed worker's thread ends")
            status.append(fut.result(timeout=WAIT_S).status)
            tail = [fab.submit(rng.choice(hot_b, size=4, replace=False),
                               tenant="batch") for _ in range(6)]
            status += [f.result(timeout=WAIT_S).status for f in tail]
            out["smoke_status"] = status
            out["smoke_healthy"] = fab.healthy()
    out["smoke_alive"] = [w.alive() for w in fab.workers]
    if mesh.leader:
        out["smoke_snapshot"] = fab.meter.snapshot()
    return out


def stage_mixed(eng) -> None:
    """Inserts, a conflicting delete, new nodes and edges to them (as
    ``test_torch_stream._stage_mixed``)."""
    eng.ingest([1, 2, 3], [4, 5, 6])
    eng.ingest([1], [4], op="delete")
    new = eng.ingest_nodes(np.arange(2 * eng.ds.feat_dim, dtype=np.float32)
                           .reshape(2, eng.ds.feat_dim),
                           labels=np.array([3, 1]))
    eng.ingest(new, [0, 7])


def store_traffic(store, rng_seed, rounds=3) -> None:
    """Per-group requests through ``assemble_input`` (as
    ``test_torch_stream._traffic``)."""
    rng = np.random.default_rng(rng_seed)
    gen = store.generation
    v = store.graph.num_nodes
    for _ in range(rounds):
        for group in (0, 1):
            lo = 0 if group == 0 else v // 2
            ids = rng.integers(lo, lo + v // 2, 64).astype(np.int64)
            store.assemble_input(gen, ids, len(ids) - 8, group=group)


def store_numpy(store) -> dict:
    gen = store.generation
    pm = gen.state.placement
    buf = store._stream
    return {"indptr": store.graph.indptr.copy(),
            "indices": store.graph.indices.copy(),
            "features": np.asarray(store.features).copy(),
            "labels": np.asarray(store.labels).copy(),
            "version": gen.version, "node_ids": gen.state.node_ids.copy(),
            "slot_of": gen.state.slot_of.copy(),
            "placement": (None if pm is None
                          else np.asarray(pm.device_row_of_slot).copy()),
            "table": gen.table.cpu().numpy(),
            "gen_nodes": gen.graph.num_nodes,
            "counters": (store.merges_applied, store.rows_migrated,
                         store.pending_deltas()),
            "delta_bytes": store.meter.bytes_delta_upload,
            "clocks": (buf.next_node, buf.next_seq)}


def _ckpt_state(eng) -> dict:
    out = {"params": params_numpy(eng),
           "pending": eng.pending_deltas,
           "clocks": (eng.stream.next_node, eng.stream.next_seq)}
    if eng.mesh.leader:
        out["stream"] = eng.stream.state()
    return out


def _merged(eng) -> dict:
    eng.merge_deltas()
    return {"indptr": eng.ds.graph.indptr.copy(),
            "indices": eng.ds.graph.indices.copy(),
            "labels": np.asarray(eng.ds.labels).copy(),
            "version": eng.store.version,
            "clocks": (eng.stream.next_node, eng.stream.next_seq)}


def stream_ranks(mesh, device, spec: dict) -> dict:
    """Streaming ingest and checkpoints on this mesh: (1) a store's
    generations across three merges of the leader's deltas; (2) the
    reference's stream smoke through a fabric; (3) save on the mesh, and
    restore the given checkpoints; (4) a follower's ingest refused."""
    from repro_torch.data import temporal_event_stream
    from repro_torch.featurestore import CacheConfig, FeatureStore
    from repro_torch.gns import FabricConfig
    from repro_torch.gns.config import StreamConfig
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.launch.mesh import NotLeader
    from repro_torch.stream import DeltaBuffer
    torch.set_num_threads(1)
    out = {"rank": mesh.rank}

    # (1) the store's generations across merges
    ds = get_dataset("tiny", seed=0)
    store = FeatureStore(ds.features, ds.graph,
                         CacheConfig(fraction=0.1, strategy="adaptive",
                                     placement="locality"),
                         device=device, train_idx=ds.train_idx,
                         build_adjacency=True, seed=0, mesh=mesh)
    store.labels = ds.labels
    store.attach_stream(DeltaBuffer(ds.graph.num_nodes, ds.feat_dim),
                        StreamConfig(merge_min_pending=1))
    store.refresh(version=0)
    gens = [store_numpy(store)]
    events = temporal_event_stream(ds, num_batches=3, events_per_batch=40,
                                   new_node_frac=0.1, seed=5)
    due = []
    for k, ev in enumerate(events, start=1):
        store_traffic(store, 100 + k)
        if mesh.leader:
            if ev.node_feats is not None:
                store._stream.add_nodes(ev.node_feats, ev.node_labels)
            store._stream.add_edges(ev.src, ev.dst)
            if k == 2:               # a delete of an edge that exists
                u = int(np.flatnonzero(store.graph.degrees)[0])
                store._stream.delete_edges(
                    [u], [int(store.graph.neighbors(u)[0])])
        due.append(store.stream_merge_due())
        store.refresh(version=k)
        gens.append(store_numpy(store))
    due.append(store.stream_merge_due())
    out["generations"], out["due"] = gens, due

    # (2) the reference's stream smoke, through a 2-worker fabric
    eng = mesh_engine(spec["smoke_cfg"], mesh, device)
    v0 = eng.ds.graph.num_nodes
    fab = eng.serve_fabric(FabricConfig(workers=2, stall_timeout_ms=10_000.0,
                                        watch_interval_ms=50.0))
    rng = np.random.default_rng(7)
    hot = rng.choice(eng.ds.val_idx, size=24, replace=False).astype(np.int64)
    stream = temporal_event_stream(eng.ds, num_batches=2,
                                   events_per_batch=24, new_node_frac=0.1,
                                   seed=3)
    v1 = v0 + stream.total_new_nodes
    smoke = {}
    with fab:
        if mesh.leader:
            fab.infer(hot[:4], timeout=WAIT_S)
            fab.infer(hot[:20], timeout=WAIT_S)
        # a pre-merge batch pinned on every rank (the engine's own sampler:
        # the fabric's bucket samplers belong to its workers)
        mb0 = eng.infer_prepare(hot[:8], bucket=32,
                                rng=np.random.default_rng(123),
                                sampler=eng.sampler)
        # the graph the batch is pinned to, held here: the second build
        # after it recycles its generation's staging half, and retire()
        # drops the generation's reference (how many builds the merges
        # take is the watchdog's timing)
        pinned = mb0.cache_gen.graph
        out0 = eng.infer_compute(mb0)
        if mesh.leader:
            futs = []
            for ev in stream:
                eng.ingest_events(ev)
                for _ in range(8):
                    ids = rng.choice(hot, size=int(rng.integers(2, 8)),
                                     replace=False)
                    futs.append(fab.submit(ids))
            smoke["status"] = [f.result(timeout=WAIT_S).status
                               for f in futs]
            wait_until(lambda: eng.store.merges_applied >= 1,
                       "a merge applied")
            wait_until(lambda: eng.pending_deltas == 0, "deltas drained")
            wait_until(lambda: fab.meter.snapshot()["swaps_observed"] >= 1,
                       "the merged generation swapped in")
        else:
            smoke["refused"] = refuses(
                lambda: eng.ingest_nodes(np.zeros((1, eng.ds.feat_dim),
                                                  np.float32)), NotLeader)
        wait_until(lambda: eng.store.generation.graph.num_nodes == v1,
                   "every merge live on this rank")
        smoke["pin_nodes"] = pinned.num_nodes
        smoke["replay_equal"] = bool(np.array_equal(
            out0, eng.infer_compute(mb0)))
        smoke["nodes"] = (v0, v1, eng.ds.graph.num_nodes)
        if mesh.leader:
            smoke["new"] = fab.infer(np.array([v0], np.int64),
                                     timeout=WAIT_S)
    eng.store.wait_refresh(timeout=WAIT_S)
    if mesh.leader:
        smoke["snapshot"] = fab.meter.snapshot()
    smoke["fabric_error"] = fab.fabric_error
    smoke["generation"] = generation_numpy(eng)
    smoke["merges"] = eng.store.merges_applied
    smoke["pending"] = eng.pending_deltas
    out["smoke"] = smoke

    # (3) checkpoints: save on the mesh with pending deltas ...
    eng = mesh_engine(spec["ckpt_cfg"], mesh, device)
    if mesh.leader:
        stage_mixed(eng)
    out["saved_path"] = str(eng.save(spec["dir_mesh"], step=4))
    out["saved"] = _ckpt_state(eng)
    out["saved_merged"] = _merged(eng)
    # ... and restore the reference's and a one-rank engine's
    out["restored"] = {}
    for name, d in spec["restore"].items():
        eng = mesh_engine(spec["ckpt_cfg"], mesh, device)
        step = eng.restore(d)
        out["restored"][name] = dict(_ckpt_state(eng), step=step,
                                     merged=_merged(eng))
    return out


def inproc_pinned_ranks(mesh, device, spec: dict) -> dict:
    """The inproc mesh fabric on this mesh, the one the tcp coordinator of
    ``tests/test_torch_mesh_rpc.py`` is held to: ``spec["pinned"]`` one at
    a time from the checkpoint ``spec["restore"]``; a follower's submit
    and a tcp fabric over the mesh engine are refused."""
    import json
    from repro_torch.gns import EngineConfig, FabricConfig, GNSEngine
    from repro_torch.launch.mesh import NotLeader
    torch.set_num_threads(1)
    out = {"rank": mesh.rank}
    cfg = EngineConfig.from_dict(json.loads(spec["cfg"]))
    eng = GNSEngine(cfg, device=device, mesh=mesh)
    eng.restore(spec["restore"])
    out["tcp_refused"] = refuses(lambda: eng.serve_fabric(FabricConfig(
        workers=2, transport="tcp", endpoints=tuple(spec["endpoints"]))),
        ValueError)
    with eng.serve_fabric(FabricConfig(workers=2,
                                       stall_timeout_ms=600_000.0)) as fab:
        if mesh.leader:
            out["inproc"] = []
            for w, ids in spec["pinned"]:
                r = fab.submit(ids, worker=w).result(timeout=WAIT_S)
                out["inproc"].append((r.status, r.bucket, r.cache_version,
                                      r.logits))
        else:
            out["refused"] = refuses(lambda: fab.submit(np.arange(3)),
                                     NotLeader)
    return out


def _children() -> list:
    """The pids of this process's children (every thread's)."""
    import os
    pids = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/children") as f:
                pids += [int(p) for p in f.read().split()]
        except OSError:
            pass
    return pids


def rpc_coordinator(spec: dict) -> dict:
    """The port's tcp coordinator over two endpoint worlds, in this one
    process (``tests/test_torch_mesh_rpc.py``): (1) ``spec["pinned"]`` one
    at a time; (2) a refresh every 4 batches, each endpoint's SWAPPED
    tables logged; (3) the reference's ``RPC_COORD_CODE`` traffic with
    endpoint 0's leader SIGKILLed.  Its engine is
    ``GNSEngine.coordinator`` of the mesh config; what it started (a
    process group, child processes) is recorded while the fabrics run."""
    import dataclasses
    import json
    import multiprocessing
    import os
    import signal
    import torch.distributed as dist
    from repro_torch.gns import (EngineConfig, FabricConfig, GNSEngine,
                                 TenantConfig)
    from repro_torch.rpc.endpoint import table_digest
    torch.set_num_threads(1)
    out = {"pid": os.getpid()}
    cfg = EngineConfig.from_dict(json.loads(spec["cfg"]))
    eng = GNSEngine.coordinator(cfg, device="cpu")
    addrs = tuple(spec["endpoints"])
    seen = {"children": set(), "dist": False}

    def look():
        seen["children"].update(_children())
        seen["children"].update(p.pid for p in
                                multiprocessing.active_children())
        seen["dist"] |= dist.is_available() and dist.is_initialized()

    # (1) one request at a time
    tcp = dict(workers=2, transport="tcp", endpoints=addrs,
               stall_timeout_ms=600_000.0, watch_interval_ms=50.0,
               heartbeat_ms=50.0)
    with eng.serve_fabric(FabricConfig(**tcp)) as fab:
        out["tcp"] = []
        for w, ids in spec["pinned"]:
            r = fab.submit(ids, worker=w).result(timeout=WAIT_S)
            out["tcp"].append((r.status, r.bucket, r.cache_version,
                               r.logits))
        out["tcp_workers"] = len(fab.workers)
        look()

    # (2) the watchdog's REFRESH after 4 batches: both endpoints swap
    swapped = []
    serve_cfg = dataclasses.replace(cfg.serve_config(), refresh_every=4)
    fab = eng.serve_fabric(FabricConfig(**tcp), serve_cfg=serve_cfg)
    remote_swap = fab._on_remote_swap

    def logged(index, table):
        swapped.append((index, None if table is None else table.version,
                        table_digest(table)))
        remote_swap(index, table)

    fab._on_remote_swap = logged
    with fab:
        ids = spec["pinned"][0][1]
        before = [fab.submit(ids, worker=i % 2).result(timeout=WAIT_S)
                  for i in range(4)]
        wait_until(lambda: {i for i, _, _ in swapped} == {0, 1},
                   "both endpoints swap in the refreshed generation")
        after = [fab.submit(ids, worker=i).result(timeout=WAIT_S)
                 for i in range(2)]
        out["refresh"] = {
            "versions": [r.cache_version for r in before + after],
            "status": [r.status for r in before + after],
            "swapped": list(swapped),
            "errors": fab.meter.snapshot()["errors"]}
        look()

    # (3) the reference's rpc smoke, endpoint 0 SIGKILLed mid-stream
    fab = eng.serve_fabric(FabricConfig(
        workers=2, transport="tcp", endpoints=addrs,
        tenants=(TenantConfig("mobile", weight=2.0, max_queue=64),
                 TenantConfig("batch", weight=1.0, max_queue=64)),
        stall_timeout_ms=5000.0, watch_interval_ms=50.0, heartbeat_ms=50.0))
    ds = eng.ds
    rng = np.random.default_rng(7)
    half = len(ds.val_idx) // 2
    hot_a = rng.choice(ds.val_idx[:half], size=30, replace=False)
    hot_b = rng.choice(ds.val_idx[half:], size=30, replace=False)
    with fab:
        futs = []
        for i in range(40):
            tenant, hot = (("mobile", hot_a) if i % 2 == 0
                           else ("batch", hot_b))
            ids = rng.choice(hot, size=int(rng.integers(2, 8)),
                             replace=False)
            futs.append(fab.submit(ids, tenant=tenant))
        status = [f.result(timeout=WAIT_S).status for f in futs]
        w0 = fab.workers[0]
        futs = [fab.submit(rng.choice(hot_a, size=4, replace=False),
                           tenant="mobile", worker=0) for _ in range(4)]
        look()
        os.kill(spec["pid0"], signal.SIGKILL)
        wait_until(lambda: not w0.alive(),
                   "the proxy of the killed endpoint ends")
        status += [f.result(timeout=WAIT_S).status for f in futs]
        tail = [fab.submit(rng.choice(hot_b, size=4, replace=False),
                           tenant="batch") for _ in range(6)]
        status += [f.result(timeout=WAIT_S).status for f in tail]
        out["smoke_status"] = status
        out["smoke_healthy"] = fab.healthy()
        out["smoke_remote"] = sorted(fab.pull_remote_stats(timeout=30.0))
        out["smoke_snapshot"] = fab.snapshot()
    out["mesh"] = eng.mesh
    out["shards"] = eng.store.n_shards
    out["children"] = sorted(seen["children"])
    out["dist"] = seen["dist"]
    return out


def endpoint_fault_ranks(mesh, device, spec: dict) -> dict:
    """An endpoint world served in this spawn, rank 1 failing its second
    batch: its forward after it ran, or with ``spec["fault"] ==
    "sampling"`` its sampling; the leader also holds a meshless tcp
    coordinator.  Returns the leader's outcome of each request, one at a
    time, and every rank's batch count."""
    import dataclasses
    import json
    import torch.distributed as dist
    from repro_torch.gns import EngineConfig, FabricConfig, GNSEngine
    from repro_torch.rpc.endpoint import build_endpoint
    torch.set_num_threads(1)
    cfg = EngineConfig.from_dict(json.loads(spec["cfg"]))
    ep = build_endpoint(cfg, {"device": str(device), "index": 0,
                              "host": "127.0.0.1", "port": 0,
                              "heartbeat_ms": 50.0}, mesh)
    if mesh.rank == 1 and spec.get("fault") == "sampling":
        prepare, calls = ep._prepare, []

        def fails_second(ids, bucket):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected sampling fault on rank 1")
            return prepare(ids, bucket)

        ep._prepare = fails_second
    elif mesh.rank == 1:
        compute, calls = ep.engine.infer_compute, []

        def fails_second(mb, meter=None, mesh=None):
            out = compute(mb, meter=meter, mesh=mesh)
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected fault on rank 1")
            return out

        ep.engine.infer_compute = fails_second
    dist.barrier(group=mesh.host_group)
    out = {"rank": mesh.rank}
    if not mesh.leader:
        ep.follow()
        out["batches"] = ep.meter.batch_count()
        return out
    serving = ep.serve_in_thread()
    coord = dataclasses.replace(cfg, mesh=None, cache=dataclasses.replace(
        cfg.cache, shards=2))
    fab = GNSEngine(coord, device="cpu").serve_fabric(FabricConfig(
        workers=1, transport="tcp", endpoints=(f"127.0.0.1:{ep.port}",),
        stall_timeout_ms=600_000.0, watch_interval_ms=50.0))
    outcome = []
    with fab:
        for ids in spec["requests"]:
            try:
                outcome.append(fab.submit(ids).result(timeout=WAIT_S).status)
            except Exception as e:          # the endpoint's error status
                outcome.append(str(e))
    ep.stop()
    serving.join(WAIT_S)
    out.update(outcome=outcome, batches=ep.meter.batch_count(),
               errors=ep.meter.snapshot()["errors"])
    return out


if __name__ == "__main__":
    # python tests/_torch_mesh_ranks.py SPEC.pkl OUT.pkl: rpc_coordinator
    # of the pickled spec, its result pickled
    import pickle
    import sys
    with open(sys.argv[1], "rb") as f:
        _spec = pickle.load(f)
    _out = rpc_coordinator(_spec)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(_out, f)
