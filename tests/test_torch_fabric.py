"""The port's ``ServeFabric`` on the CPU: parity with the reference where
the scenario is deterministic, and the chaos battery with bounded,
predicate-based waits.

* Requests pinned with ``submit(worker=i)`` and sent one at a time draw
  from the same per-worker rng (``seed + 0xFAB0 + i``) in both packages, so
  their logits agree within rtol 1e-4 / atol 1e-4.
* A flooding tenant collects its own ``QueueFull`` (exactly its quota per
  worker is admitted while the workers are held); another tenant's
  admissions are untouched.
* A stalled worker is routed around and then recovers; a killed worker's
  in-flight batch is reclaimed and served; with every worker dead,
  requests fail fast with ``WorkerDown``.
* A batch pinned to generation g gives bitwise the same logits after a
  swap to g+1 under it.
* Streaming deltas staged while the fabric serves are drained by its
  watchdog (an async build, held open by the store's ``refresh_delay``
  hook while serving goes on), swapped in, and a new node is served.

Every wait polls a predicate with a deadline; the only sleeps are the
workers' own chaos hook (``stall_s``), each far longer than the watchdog's
stall timeout or far shorter than the waits around it.  The runtime lock
sanitizer is armed (``tests/conftest.py``).
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import jax_params_to_numpy  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import FabricConfig as FabricConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.graph.datasets import get_dataset as get_dataset_ref  # noqa: E402
from repro_torch.analysis import TrackedLock  # noqa: E402
from repro_torch.data import temporal_event_stream  # noqa: E402
from repro_torch.gns import (EngineConfig, FabricConfig, GNSEngine,  # noqa: E402
                             TenantConfig)
from repro_torch.models.graphsage import params_from_numpy  # noqa: E402
from repro_torch.serve import QueueFull, ServeFabric, WorkerDown  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
WAIT_S = 60.0


def _wait(pred, timeout=WAIT_S, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _cfg_json(shards=1, stream=False) -> str:
    from repro.core.sampler import SamplerConfig
    from repro.featurestore import CacheConfig
    from repro.gns.config import (DataConfig, ModelConfig, ServeConfig,
                                  StreamConfig)
    cache = (CacheConfig(fraction=0.1) if shards == 1 else
             CacheConfig(fraction=0.1, strategy="adaptive",
                         placement="locality", shards=shards))
    scfg = SamplerConfig(fanouts=(3, 4), batch_size=32, cache=cache)
    cfg = EngineConfigRef(
        sampler="gns", data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=scfg.cache,
        model=ModelConfig(hidden_dim=32, aggregate_impl="pallas",
                          input_impl="fused"),
        serve=ServeConfig(buckets=(8, 32), max_wait_ms=2.0),
        stream=StreamConfig(merge_min_pending=1) if stream else None,
        seed=3)
    return json.dumps(cfg.to_dict())


def _engine(**kw):
    return GNSEngine(EngineConfig.from_dict(json.loads(_cfg_json(**kw))),
                     device="cpu")


def _fabric(eng, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("stall_timeout_ms", 60_000.0)
    kw.setdefault("watch_interval_ms", 10.0)
    return ServeFabric(eng, cfg=FabricConfig(**kw))


def _val_chunks(eng, n, size):
    idx = eng.ds.val_idx.astype(np.int64)
    return [idx[i * size:(i + 1) * size] for i in range(n)]


def _served_lanes(fab):
    """Tier lookups the fabric's sampling windows have booked: it grows
    once a worker's batch is assembled against its pinned generation."""
    dev = fab.meter.traffic.tier("device")
    return dev.hits + dev.misses


# ---------------------------------------------------------------------------
# parity with the reference fabric
# ---------------------------------------------------------------------------

def test_pinned_requests_match_reference_fabric():
    text = _cfg_json()
    ref = EngineRef(EngineConfigRef.from_dict(json.loads(text)),
                    dataset=get_dataset_ref("tiny", seed=0))
    port = GNSEngine(EngineConfig.from_dict(json.loads(text)), device="cpu")
    port.params = params_from_numpy(jax_params_to_numpy(ref.params),
                                    device="cpu")
    reqs = [(0, 5), (1, 3), (0, 12), (1, 20)]        # (worker, ids)
    rng = np.random.default_rng(4)
    ids = [rng.choice(port.ds.graph.num_nodes, n, replace=False)
           for _, n in reqs]
    results = []
    for eng, fcfg in ((ref, FabricConfigRef), (port, FabricConfig)):
        from repro.serve import ServeFabric as ServeFabricRef
        cls = ServeFabricRef if eng is ref else ServeFabric
        fab = cls(eng, cfg=fcfg(workers=2, stall_timeout_ms=600_000.0))
        with fab:
            results.append([fab.submit(x, worker=w).result(timeout=600)
                            for (w, _), x in zip(reqs, ids)])
        snap = fab.meter.snapshot()
        assert snap["errors"] == 0 and fab.fabric_error is None
    for r, p, x in zip(*results, ids):
        assert r.status == p.status == "ok"
        assert (r.bucket, r.cache_version) == (p.bucket, p.cache_version)
        assert p.logits.shape == (len(x), port.ds.num_classes)
        np.testing.assert_allclose(p.logits, r.logits, **TOL)


# ---------------------------------------------------------------------------
# tenants
# ---------------------------------------------------------------------------

def test_flooding_tenant_is_refused_at_its_own_quota():
    eng = _engine()
    fab = _fabric(eng, tenants=(TenantConfig("flood", max_queue=3),
                                TenantConfig("quiet", max_queue=64)))
    chunks = _val_chunks(eng, 2, 4)
    with fab:
        for w in fab.workers:
            w.stall_s = 2.0                          # hold both workers
        held = []
        for i, w in enumerate(fab.workers):
            lanes = _served_lanes(fab)
            held.append(fab.submit(chunks[i], tenant="quiet", worker=i))
            assert _wait(lambda: _served_lanes(fab) > lanes)
        rng = np.random.default_rng(7)
        n = eng.ds.graph.num_nodes
        admitted, rejected = [], 0
        for _ in range(40):
            try:
                admitted.append(fab.submit(rng.integers(0, n, 4),
                                           tenant="flood"))
            except QueueFull:
                rejected += 1
        quiet = [fab.submit(rng.integers(0, n, 4), tenant="quiet")
                 for _ in range(10)]                 # none refused
        for w in fab.workers:
            w.stall_s = 0.0
        res = [f.result(timeout=WAIT_S) for f in held + admitted + quiet]
    assert len(admitted) == 6 and rejected == 34     # 3 per worker
    assert all(r.status == "ok" for r in res)
    snap = fab.meter.snapshot()
    assert snap["tenants"]["flood"]["rejected"] == 34
    assert snap["tenants"]["quiet"]["rejected"] == 0
    assert snap["tenants"]["quiet"]["served"] == 12
    assert snap["errors"] == 0 and fab.fabric_error is None
    counters = fab.snapshot()["scheduler_counters"]
    assert sum(c["flood"]["offered"] for c in counters.values()) == 6
    assert fab.pull_remote_stats() == {}
    assert fab.rpc_traffic() == {"bytes_rpc_tx": 0, "bytes_rpc_rx": 0}


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------

def test_stalled_worker_is_routed_around_then_recovers():
    eng = _engine()
    fab = _fabric(eng, stall_timeout_ms=100.0)
    assert isinstance(fab._sample_lock, TrackedLock)
    chunks = _val_chunks(eng, 4, 4)
    with fab:
        fab.infer(chunks[0], timeout=WAIT_S)
        w0 = fab.workers[0]
        w0.stall_s = 3.0                             # 30x the stall timeout
        lanes = _served_lanes(fab)
        stuck = fab.submit(chunks[0], worker=0)
        assert _wait(lambda: _served_lanes(fab) > lanes)
        queued = [fab.submit(c, worker=0) for c in chunks[1:]]
        assert _wait(lambda: fab.healthy() == [1]), fab.healthy()
        for f in queued:                              # re-routed to worker 1
            assert f.result(timeout=WAIT_S).status == "ok"
        w0.stall_s = 0.0
        assert stuck.result(timeout=WAIT_S).status == "ok"
        assert _wait(lambda: fab.healthy() == [0, 1]), fab.healthy()
    m = fab.meter
    assert m.failovers >= 1 and m.retries_total >= 3
    snap = m.snapshot()
    assert snap["errors"] == 0 and fab.fabric_error is None
    # the three re-routed requests may share one micro-batch on worker 1
    assert snap["routing"]["worker_batches"].get(1, 0) >= 1
    assert snap["served"] == 5


def test_killed_worker_inflight_batch_is_reclaimed_and_served():
    eng = _engine()
    fab = _fabric(eng, stall_timeout_ms=1000.0)
    chunks = _val_chunks(eng, 2, 8)
    with fab:
        fab.infer(chunks[0], timeout=WAIT_S)
        w0 = fab.workers[0]
        w0.kill()                   # the next batch aborts the thread
        fut = fab.submit(chunks[1], worker=0)
        assert _wait(lambda: not w0.alive()), "worker thread did not die"
        assert fut.result(timeout=WAIT_S).status == "ok"
        assert _wait(lambda: fab.healthy() == [1]), fab.healthy()
        assert fab.infer(chunks[0], timeout=WAIT_S).shape[0] == 8
    m = fab.meter
    assert m.failovers >= 1 and m.retries_total >= 1
    assert m.errors == 0 and fab.fabric_error is None


def test_all_workers_dead_fail_fast():
    eng = _engine()
    fab = _fabric(eng, workers=1, stall_timeout_ms=1000.0)
    chunk = _val_chunks(eng, 1, 4)[0]
    with fab:
        fab.infer(chunk, timeout=WAIT_S)
        w0 = fab.workers[0]
        w0.kill()
        fut = fab.submit(chunk, worker=0)
        assert _wait(lambda: not w0.alive())
        with pytest.raises(WorkerDown):
            fut.result(timeout=WAIT_S)
        assert _wait(lambda: fab.healthy() == [])
        with pytest.raises(WorkerDown):
            fab.submit(chunk)


# ---------------------------------------------------------------------------
# the generation pin
# ---------------------------------------------------------------------------

def test_pinned_batch_is_bitwise_the_same_across_a_swap():
    """Two fabrics, same seed, every request pinned to worker 0 and sent
    one at a time.  In the second, the last batch is held after it was
    assembled (``stall_s``) while a synchronous ``refresh()`` publishes
    g+1 under it: its logits equal the first run's bit for bit and stay on
    generation g; the next request adopts g+1."""
    def run(swap_under_last):
        eng = _engine()
        chunks = _val_chunks(eng, 4, 8)
        out = []
        with _fabric(eng) as fab:
            w0 = fab.workers[0]
            for i, ids in enumerate(chunks):
                if not (swap_under_last and i == len(chunks) - 1):
                    out.append(fab.submit(ids, worker=0).result(WAIT_S))
                    continue
                w0.stall_s = 1.0
                lanes = _served_lanes(fab)
                fut = fab.submit(ids, worker=0)
                assert _wait(lambda: _served_lanes(fab) > lanes)
                v0 = eng.store.version
                eng.store.refresh(np.random.default_rng(99), version=v0 + 1)
                assert eng.store.version == v0 + 1
                out.append(fut.result(timeout=WAIT_S))
                w0.stall_s = 0.0
            if swap_under_last:
                follow = fab.submit(chunks[0], worker=0).result(WAIT_S)
                assert follow.cache_version == out[-1].cache_version + 1
            assert fab.meter.snapshot()["errors"] == 0
            assert fab.fabric_error is None
        return out

    plain = run(False)
    swapped = run(True)
    for a, b in zip(plain, swapped):
        assert a.status == b.status == "ok"
        assert a.cache_version == b.cache_version == 0
        np.testing.assert_array_equal(a.logits, b.logits)


# ---------------------------------------------------------------------------
# streaming ingest under a live fabric
# ---------------------------------------------------------------------------

def test_watchdog_drains_deltas_while_serving():
    eng = _engine(shards=2, stream=True)
    v0 = eng.ds.graph.num_nodes
    rng = np.random.default_rng(9)
    half = len(eng.ds.val_idx) // 2
    hot = (eng.ds.val_idx[:half][:12].astype(np.int64),
           eng.ds.val_idx[half:][:12].astype(np.int64))

    def burst(fab, n=8):
        futs = [fab.submit(rng.choice(hot[i % 2], 4, replace=False))
                for i in range(n)]
        assert all(f.result(timeout=WAIT_S).status == "ok" for f in futs)

    with _fabric(eng, stall_timeout_ms=5000.0) as fab:
        burst(fab)
        eng.store.refresh_delay = 0.5      # hold the merging build open
        stream = temporal_event_stream(eng.ds, num_batches=2,
                                       events_per_batch=24,
                                       new_node_frac=0.1, seed=3)
        for ev in stream:
            eng.ingest_events(ev)
        assert _wait(lambda: eng.store.refreshing)
        assert _wait(lambda: eng.pending_deltas == 0)  # drained by the build
        burst(fab)                          # serving goes on meanwhile
        assert _wait(lambda: eng.store.generation.graph.num_nodes
                     == v0 + stream.total_new_nodes), "merge never swapped"
        eng.store.refresh_delay = 0.0
        assert _wait(lambda: fab.router.table_version
                     == eng.store.version)   # the router re-adopted
        new = np.arange(v0, v0 + stream.total_new_nodes)
        out = fab.infer(new, timeout=WAIT_S)
        assert out.shape == (len(new), eng.ds.num_classes)
        assert np.isfinite(out).all()
        burst(fab)
    snap = fab.meter.snapshot()
    assert snap["errors"] == 0 and fab.fabric_error is None
    assert snap["swaps_observed"] >= 1
    # one merge, or two when the watchdog kicked a build between the two
    # event batches
    assert eng.store.merges_applied in (1, 2)
    rec = eng.describe()["stream"]
    assert rec["merges_applied"] == eng.store.merges_applied
    assert rec["pending_deltas"] == 0


def test_fabric_example_twin_runs():
    """``examples/serve_fabric_torch.py`` on the CPU at test size, with a
    worker killed midway."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(repo / "examples" / "serve_fabric_torch.py"),
         "--device", "cpu", "--dataset", "tiny", "--scale", "1",
         "--requests", "40", "--fit-batches", "2", "--kill-worker"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mobile: served   40  rejected    0" in proc.stdout
    assert "healthy workers at exit: [1]" in proc.stdout
