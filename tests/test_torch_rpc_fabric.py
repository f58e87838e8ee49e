"""The port's RPC transport under ``ServeFabric(transport="tcp")`` on the
CPU, on the reference's tiny two-shard engine (``tests/test_rpc_fabric.py``)
with ``device="cpu"``.

In one process (endpoints served on threads, the runtime lock sanitizer
armed by ``tests/conftest.py``):

* tcp serves the same request stream bit for bit as the port's inproc
  fabric: logits, ``cache_version`` and ``bucket`` (same seeds, same
  generation, same routing);
* an endpoint survives its coordinator and is adopted again by the next;
* a severed endpoint's shipped-but-unanswered requests are served by the
  survivor; with every endpoint dead, requests fail fast;
* ``Router.adopt`` is safe while routing goes on;
* remote stats aggregate into the coordinator's meter, and the per-request
  rpc wait is split out of queue wait.

Mixed fleets hold the protocol, not only the bytes: the reference's
coordinator drives port endpoints, the port's coordinator drives reference
endpoints, and both match the reference's inproc logits within ``TOL``.

Two processes: ``python -m repro_torch.rpc.endpoint --device cpu`` twice,
and this process's coordinator SIGKILLs endpoint 0 mid-stream.

Every wait polls a predicate or reads a line with a deadline; the only
sleep is the endpoints' own chaos hook (``stall_s``).  Ephemeral ports on
127.0.0.1 only.
"""
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import jax_params_to_numpy  # noqa: E402
from repro.core.sampler import SamplerConfig as SamplerConfigRef  # noqa: E402
from repro.featurestore import CacheConfig as CacheConfigRef  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import FabricConfig as FabricConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.gns import ServeConfig as ServeConfigRef  # noqa: E402
from repro.graph.datasets import get_dataset as get_dataset_ref  # noqa: E402
from repro.rpc import WorkerEndpoint as WorkerEndpointRef  # noqa: E402
from repro.serve import ServeFabric as ServeFabricRef  # noqa: E402
from repro_torch.core.sampler import SamplerConfig  # noqa: E402
from repro_torch.featurestore import CacheConfig  # noqa: E402
from repro_torch.featurestore.placement import RoutingTable  # noqa: E402
from repro_torch.gns import (EngineConfig, FabricConfig, GNSEngine,  # noqa: E402
                             ServeConfig, TenantConfig)
from repro_torch.graph.datasets import get_dataset  # noqa: E402
from repro_torch.models.graphsage import params_from_numpy  # noqa: E402
from repro_torch.rpc import (RemoteWorkerProxy, WorkerEndpoint,  # noqa: E402
                             parse_endpoint)
from repro_torch.serve import Router, ServeFabric, WorkerDown  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_fabric.py's
WAIT_S = 120.0
REPO = Path(__file__).resolve().parents[1]


def _wait(pred, timeout=WAIT_S, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _mk_engine(seed=0):
    """The reference test's tiny engine, on the port (fresh dataset per
    engine: each endpoint replica owns its own copy)."""
    ds = get_dataset("tiny", seed=0)
    scfg = SamplerConfig(fanouts=(3, 4), batch_size=32,
                         cache=CacheConfig(fraction=0.1,
                                           placement="locality", shards=2))
    cfg = EngineConfig(sampler="gns", sampling=scfg, cache=scfg.cache,
                       serve=ServeConfig(buckets=(8, 32), max_wait_ms=2.0),
                       seed=seed)
    return GNSEngine(cfg, device="cpu", dataset=ds)


def _mk_engine_ref(seed=0):
    """``tests/test_rpc_fabric.py``'s ``_mk_engine``."""
    ds = get_dataset_ref("tiny", seed=0)
    scfg = SamplerConfigRef(fanouts=(3, 4), batch_size=32,
                            cache=CacheConfigRef(fraction=0.1,
                                                 placement="locality",
                                                 shards=2))
    cfg = EngineConfigRef(sampler="gns", sampling=scfg, cache=scfg.cache,
                          serve=ServeConfigRef(buckets=(8, 32),
                                               max_wait_ms=2.0),
                          seed=seed)
    return EngineRef(cfg, dataset=ds)


def _serve_endpoints(engines, cls=WorkerEndpoint, heartbeat_ms=25.0):
    eps = []
    for i, eng in enumerate(engines):
        ep = cls(eng, index=i, heartbeat_ms=heartbeat_ms)
        ep.serve_in_thread()                 # bind() runs synchronously
        eps.append(ep)
    return eps


def _endpoints(n=2, seed=0):
    return _serve_endpoints([_mk_engine(seed) for _ in range(n)])


def _tcp_cfg(cls, eps, **kw):
    kw.setdefault("stall_timeout_ms", 5000.0)
    kw.setdefault("watch_interval_ms", 20.0)
    return cls(workers=len(eps), transport="tcp",
               endpoints=tuple(f"127.0.0.1:{ep.port}" for ep in eps), **kw)


def _tcp_fabric(eng, eps, **kw):
    return ServeFabric(eng, cfg=_tcp_cfg(FabricConfig, eps, **kw))


def _stop(eps):
    for ep in eps:
        ep.stop()
    for ep in eps:
        if isinstance(ep, WorkerEndpoint):     # the reference's has no join
            assert ep.join(), f"endpoint {ep.index}'s threads still run"


def _request_stream(ds, n=14):
    """The reference test's deterministic mixed-tenant request sequence."""
    rng = np.random.default_rng(42)
    out = []
    for i in range(n):
        ids = rng.choice(ds.val_idx, size=int(rng.integers(2, 8)),
                         replace=False).astype(np.int64)
        out.append(("mobile" if i % 2 == 0 else "batch", ids))
    return out


def _serve_one_at_a_time(fab, reqs, pin=False):
    with fab:
        return [fab.submit(ids, tenant=tenant,
                           worker=(i % 2 if pin else None))
                .result(timeout=WAIT_S)
                for i, (tenant, ids) in enumerate(reqs)]


# ---------------------------------------------------------------------------
# config surface
# ---------------------------------------------------------------------------

def test_fabric_config_tcp_json_roundtrip():
    cfg = EngineConfig(
        serve=ServeConfig(fabric=FabricConfig(
            workers=2, transport="tcp",
            endpoints=("127.0.0.1:7001", "hostb:7002"),
            heartbeat_ms=50.0, connect_retries=3)))
    d = json.loads(json.dumps(cfg.to_dict()))
    back = EngineConfig.from_dict(d).serve.fabric
    assert back.transport == "tcp"
    assert back.endpoints == ("127.0.0.1:7001", "hostb:7002")
    assert back.heartbeat_ms == 50.0 and back.connect_retries == 3
    # the reference reads the port's JSON
    ref = EngineConfigRef.from_dict(d).serve.fabric
    assert (ref.transport, ref.endpoints) == ("tcp", back.endpoints)

    assert parse_endpoint("hostb:7002") == ("hostb", 7002)
    assert parse_endpoint(":7002") == ("127.0.0.1", 7002)
    assert parse_endpoint("7002") == ("127.0.0.1", 7002)


def test_tcp_fabric_needs_one_endpoint_per_worker():
    eng = _mk_engine()
    with pytest.raises(ValueError, match="one endpoint per worker"):
        ServeFabric(eng, cfg=FabricConfig(workers=2, transport="tcp",
                                          endpoints=("127.0.0.1:1",)))
    fab = eng.serve_fabric(FabricConfig(
        workers=2, transport="tcp",
        endpoints=("127.0.0.1:1", "127.0.0.1:2")))
    assert all(isinstance(w, RemoteWorkerProxy) for w in fab.workers)
    # the coordinator computes nothing: no generation is built for it
    assert eng.store.generation is None


# ---------------------------------------------------------------------------
# bitwise identity: tcp == inproc
# ---------------------------------------------------------------------------

def test_tcp_results_bitwise_identical_to_inproc():
    reqs = _request_stream(get_dataset("tiny", seed=0))
    inproc = _serve_one_at_a_time(
        ServeFabric(_mk_engine(seed=4), cfg=FabricConfig(workers=2)), reqs)
    eps = _endpoints(2, seed=4)
    try:
        coord = _mk_engine(seed=4)
        fab = _tcp_fabric(coord, eps)
        tcp = _serve_one_at_a_time(fab, reqs)
    finally:
        _stop(eps)
    assert coord.store.generation is None    # generation 0 lives remotely
    assert all(r.status == "ok" for r in inproc + tcp)
    for a, b in zip(inproc, tcp):
        np.testing.assert_array_equal(a.logits, b.logits)
        assert a.cache_version == b.cache_version
        assert a.bucket == b.bucket
    rpc = fab.rpc_traffic()
    assert rpc["bytes_rpc_tx"] > 0 and rpc["bytes_rpc_rx"] > 0
    assert fab.snapshot()["rpc"] == rpc


def test_endpoint_survives_coordinator_and_readopts():
    eps = _endpoints(1, seed=6)
    try:
        ids = get_dataset("tiny", seed=0).val_idx[:4].astype(np.int64)
        fab1 = _tcp_fabric(_mk_engine(seed=6), eps)
        with fab1:
            r1 = fab1.submit(ids).result(timeout=WAIT_S)
        # fab1 disconnected cleanly; the endpoint keeps its warm replica
        fab2 = _tcp_fabric(_mk_engine(seed=6), eps)
        with fab2:
            r2 = fab2.submit(ids).result(timeout=WAIT_S)
            stats = fab2.pull_remote_stats(timeout=30.0)
    finally:
        _stop(eps)
    assert r1.status == "ok" and r2.status == "ok"
    assert r2.cache_version == r1.cache_version   # no rebuild between
    assert r2.logits.shape == r1.logits.shape
    # the replica's ledger spans both coordinator sessions
    assert stats[0]["counters"]["served"] == 2


# ---------------------------------------------------------------------------
# chaos: mid-stream endpoint loss
# ---------------------------------------------------------------------------

def test_killed_endpoint_inflight_rerouted_to_survivor():
    eps = _endpoints(2, seed=7)
    try:
        ds = get_dataset("tiny", seed=0)
        fab = _tcp_fabric(_mk_engine(seed=7), eps)
        with fab:
            fab.submit(ds.val_idx[:4], worker=0).result(timeout=WAIT_S)
            fab.submit(ds.val_idx[:4], worker=1).result(timeout=WAIT_S)
            w1 = fab.workers[1]
            # hold results on endpoint 1 so requests sit shipped-but-
            # unanswered, then sever the connection mid-flight
            eps[1].stall_s = 0.5
            futs = [fab.submit(ds.val_idx[i * 4:(i + 1) * 4], worker=1)
                    for i in range(3)]
            assert _wait(lambda: w1.inflight_count() > 0)
            w1.kill()                        # one-call network partition
            assert _wait(lambda: not w1.alive()), "sender thread stuck"
            for f in futs:                   # the survivor serves all
                assert f.result(timeout=WAIT_S).status == "ok"
            assert _wait(lambda: fab.healthy() == [0]), fab.healthy()
            assert fab.infer(ds.val_idx[:4], timeout=WAIT_S).shape[0] == 4
        m = fab.meter
        assert m.failovers >= 1 and m.retries_total >= 1
        assert m.errors == 0 and fab.fabric_error is None
        # endpoint 1 still runs (a partition, not a crash): it reconnects
        eps[1].stall_s = 0.0
        fab2 = _tcp_fabric(_mk_engine(seed=7), [eps[1]])
        with fab2:
            assert fab2.infer(ds.val_idx[:4], timeout=WAIT_S).shape[0] == 4
    finally:
        _stop(eps)


def test_all_endpoints_dead_fails_fast():
    eps = _endpoints(1, seed=8)
    try:
        ds = get_dataset("tiny", seed=0)
        fab = _tcp_fabric(_mk_engine(seed=8), eps)
        with fab:
            fab.infer(ds.val_idx[:4], timeout=WAIT_S)     # warm
            w0 = fab.workers[0]
            eps[0].stall_s = 0.5
            fut = fab.submit(ds.val_idx[:8], worker=0)
            assert _wait(lambda: w0.inflight_count() > 0)
            w0.kill()
            assert _wait(lambda: not w0.alive())
            with pytest.raises(WorkerDown):
                fut.result(timeout=WAIT_S)
            assert _wait(lambda: fab.healthy() == [])
            with pytest.raises(WorkerDown):
                fab.submit(ds.val_idx[:4])
    finally:
        _stop(eps)


# ---------------------------------------------------------------------------
# Router.adopt vs concurrent route (the snapshot-swap contract)
# ---------------------------------------------------------------------------

def test_router_adopt_concurrent_with_route():
    """The channel receiver threads (SWAPPED frames) adopt tables while
    submit threads route."""
    router = Router(range(2), 2, mode="locality")
    rng = np.random.default_rng(0)
    tables = [RoutingTable(
        shard_of_node=rng.integers(-1, 2, size=500).astype(np.int16),
        n_shards=2, version=v) for v in range(8)]
    router.adopt(tables[0])
    stop = threading.Event()
    errs = []
    routed = [0] * 4

    def route_loop(j):
        r = np.random.default_rng(1 + j)
        try:
            while not stop.is_set():
                d = router.route(r.integers(0, 500, size=6), [0, 1])
                assert d.worker in (0, 1)
                routed[j] += 1
        except BaseException as e:          # pragma: no cover
            errs.append(e)
            raise

    def adopt_loop():
        try:
            for i in range(400):
                router.adopt(tables[i % len(tables)])
        except BaseException as e:          # pragma: no cover
            errs.append(e)
            raise

    readers = [threading.Thread(target=route_loop, args=(j,))
               for j in range(4)]
    writer = threading.Thread(target=adopt_loop)
    for t in readers:
        t.start()
    writer.start()
    writer.join(WAIT_S)
    assert _wait(lambda: all(routed)), routed   # every reader ran
    stop.set()
    for t in readers:
        t.join(WAIT_S)
    assert not writer.is_alive() and not any(t.is_alive() for t in readers)
    assert not errs, errs
    assert router.table_version == tables[399 % len(tables)].version


# ---------------------------------------------------------------------------
# cross-host observability
# ---------------------------------------------------------------------------

def test_remote_stats_aggregation_and_rpc_wait_split():
    eps = _endpoints(2, seed=9)
    try:
        ds = get_dataset("tiny", seed=0)
        fab = _tcp_fabric(_mk_engine(seed=9), eps)
        with fab:
            for tenant, ids in _request_stream(ds, n=8):
                fab.submit(ids, tenant=tenant).result(timeout=WAIT_S)
            raw = fab.pull_remote_stats(timeout=30.0)
            snap = fab.snapshot()
        # the endpoints' own tx, read under their send locks: every frame
        # the coordinator counted is booked there
        ep_tx = sum(ep.wire_tx() for ep in eps)
    finally:
        _stop(eps)
    assert set(raw) == {0, 1}
    for idx, stats in raw.items():
        assert stats["index"] == idx
        assert stats["counters"]["bytes_rpc_rx"] > 0
    assert sum(s["counters"]["served"] for s in raw.values()) == 8
    assert set(snap["remote"]) == {"0", "1"}
    offered = sum(c.get("mobile", {}).get("offered", 0)
                  for c in snap["scheduler_counters"].values())
    assert offered == 4
    assert "rpc_wait_p99_ms" in snap
    assert snap["errors"] == 0
    assert snap["rpc"]["bytes_rpc_tx"] > 0
    assert snap["rpc"]["bytes_rpc_rx"] > 0
    assert ep_tx >= snap["rpc"]["bytes_rpc_rx"]


# ---------------------------------------------------------------------------
# mixed fleets: the protocol across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_inproc():
    """The reference's inproc fabric on the stream, pinned alternately to
    workers 0 and 1 and sent one at a time: the logits both mixed fleets
    are held to, and the reference's parameters."""
    reqs = _request_stream(get_dataset_ref("tiny", seed=0), n=8)
    eng = _mk_engine_ref(seed=5)
    res = _serve_one_at_a_time(
        ServeFabricRef(eng, cfg=FabricConfigRef(workers=2)), reqs, pin=True)
    return reqs, res, jax_params_to_numpy(eng.params)


def _assert_matches(got, want):
    assert all(r.status == "ok" for r in got + want)
    for a, b in zip(want, got):
        assert (a.cache_version, a.bucket) == (b.cache_version, b.bucket)
        np.testing.assert_allclose(b.logits, a.logits, **TOL)


def test_reference_coordinator_drives_port_endpoints(ref_inproc):
    reqs, want, params = ref_inproc
    engines = [_mk_engine(seed=5) for _ in range(2)]
    for eng in engines:
        eng.params = params_from_numpy(params, device="cpu")
    eps = _serve_endpoints(engines)
    try:
        fab = ServeFabricRef(_mk_engine_ref(seed=5),
                             cfg=_tcp_cfg(FabricConfigRef, eps))
        with fab:
            got = [fab.submit(ids, tenant=tenant, worker=i % 2)
                   .result(timeout=WAIT_S)
                   for i, (tenant, ids) in enumerate(reqs)]
            stats = fab.pull_remote_stats(timeout=30.0)
    finally:
        _stop(eps)
    _assert_matches(got, want)
    assert fab.meter.snapshot()["errors"] == 0
    assert {i: s["counters"]["served"] for i, s in stats.items()} == {
        0: len(reqs) // 2, 1: len(reqs) // 2}
    assert fab.rpc_traffic()["bytes_rpc_rx"] > 0


def test_port_coordinator_drives_reference_endpoints(ref_inproc):
    reqs, want, _ = ref_inproc
    eps = _serve_endpoints([_mk_engine_ref(seed=5) for _ in range(2)],
                           cls=WorkerEndpointRef)
    try:
        fab = _tcp_fabric(_mk_engine(seed=5), eps)
        with fab:
            got = [fab.submit(ids, tenant=tenant, worker=i % 2)
                   .result(timeout=WAIT_S)
                   for i, (tenant, ids) in enumerate(reqs)]
            stats = fab.pull_remote_stats(timeout=30.0)
    finally:
        _stop(eps)
    _assert_matches(got, want)
    assert fab.meter.snapshot()["errors"] == 0
    assert {i: s["counters"]["served"] for i, s in stats.items()} == {
        0: len(reqs) // 2, 1: len(reqs) // 2}
    # the routing table came over the wire from endpoint 0's replica
    assert fab.router.table_version == eps[0].engine.store.version


# ---------------------------------------------------------------------------
# two endpoint processes, a SIGKILL mid-stream
# ---------------------------------------------------------------------------

def _smoke_config() -> dict:
    """The reference smoke's shape on one device: 2 cache shards, fused
    input, locality placement, adaptive policy."""
    from repro_torch.gns.config import ModelConfig
    scfg = SamplerConfig(fanouts=(3, 4), batch_size=32,
                         cache=CacheConfig(fraction=0.05,
                                           strategy="adaptive",
                                           placement="locality", shards=2))
    return EngineConfig(
        sampler="gns", sampling=scfg, cache=scfg.cache,
        model=ModelConfig(input_impl="fused", hidden_dim=16),
        serve=ServeConfig(buckets=(8, 32), max_wait_ms=2.0),
        seed=0).to_dict()


def _lines(proc) -> "queue.Queue":
    """A queue fed with ``proc``'s stdout lines by a daemon thread (reads
    with a deadline, never a blocking readline)."""
    q: queue.Queue = queue.Queue()

    def pump():
        with proc.stdout:
            for line in proc.stdout:
                q.put(line)
        q.put(None)                          # EOF

    threading.Thread(target=pump, daemon=True).start()
    return q


def _ready_port(q, proc, err_path) -> int:
    try:
        line = q.get(timeout=WAIT_S)
    except queue.Empty:
        line = None
    assert line and "GNS_ENDPOINT_READY" in line, (
        line, proc.poll(), Path(err_path).read_text()[-3000:])
    return int(dict(kv.split("=") for kv in line.split()[1:])["port"])


def test_rpc_two_processes_survive_sigkill(tmp_path):
    cfg_path = tmp_path / "engine.json"
    cfg_path.write_text(json.dumps(_smoke_config()))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_LOCK_SANITIZER="1")
    procs, ports = [], []
    try:
        for i in range(2):
            err = open(tmp_path / f"ep{i}.err", "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.rpc.endpoint",
                 "--config", str(cfg_path), "--index", str(i), "--port", "0",
                 "--heartbeat-ms", "50", "--device", "cpu"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err,
                text=True))
            err.close()
        for i, p in enumerate(procs):
            ports.append(_ready_port(_lines(p), p, tmp_path / f"ep{i}.err"))

        eng = GNSEngine(EngineConfig.from_dict(_smoke_config()),
                        device="cpu")
        fab = eng.serve_fabric(FabricConfig(
            workers=2, transport="tcp",
            endpoints=tuple(f"127.0.0.1:{p}" for p in ports),
            tenants=(TenantConfig("mobile", weight=2.0, max_queue=64),
                     TenantConfig("batch", weight=1.0, max_queue=64)),
            stall_timeout_ms=5000.0, watch_interval_ms=50.0,
            heartbeat_ms=50.0))
        rng = np.random.default_rng(7)
        half = len(eng.ds.val_idx) // 2
        hot_a = rng.choice(eng.ds.val_idx[:half], size=30, replace=False)
        hot_b = rng.choice(eng.ds.val_idx[half:], size=30, replace=False)
        with fab:
            futs = []
            for i in range(40):
                tenant, hot = (("mobile", hot_a) if i % 2 == 0
                               else ("batch", hot_b))
                ids = rng.choice(hot, size=int(rng.integers(2, 8)),
                                 replace=False)
                futs.append(fab.submit(ids, tenant=tenant))
            assert all(f.result(timeout=WAIT_S).status == "ok"
                       for f in futs)
            # chaos: SIGKILL endpoint 0 with pinned requests in flight
            w0 = fab.workers[0]
            futs = [fab.submit(rng.choice(hot_a, size=4, replace=False),
                               tenant="mobile", worker=0)
                    for _ in range(16)]
            assert _wait(lambda: w0.inflight_count() > 0)
            os.kill(procs[0].pid, signal.SIGKILL)
            assert _wait(lambda: not w0.alive()), "proxy outlived the kill"
            assert all(f.result(timeout=WAIT_S).status == "ok"
                       for f in futs)
            tail = [fab.submit(rng.choice(hot_b, size=4, replace=False),
                               tenant="batch") for _ in range(6)]
            assert all(f.result(timeout=WAIT_S).status == "ok"
                       for f in tail)
            assert _wait(lambda: fab.healthy() == [1]), fab.healthy()
            remote = fab.pull_remote_stats(timeout=30.0)
            snap = fab.snapshot()
        assert set(remote) == {1}, remote
        rt = snap["routing"]
        assert rt["routed_known_ids"] > 0, rt
        assert rt["failovers"] >= 1 and rt["retries"] >= 1, rt
        assert snap["errors"] == 0 and fab.fabric_error is None, snap
        assert snap["rpc"]["bytes_rpc_tx"] > 0
        assert snap["rpc"]["bytes_rpc_rx"] > 0
        assert "rpc_wait_p99_ms" in snap
        # endpoint 0 was SIGKILLed; endpoint 1 outlives its coordinator
        assert procs[0].wait(timeout=WAIT_S) == -signal.SIGKILL
        assert procs[1].poll() is None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=WAIT_S)


@pytest.mark.parametrize("mode", [["--kill-endpoint"], ["--in-thread"]])
def test_rpc_example_twin_runs(mode):
    """``examples/serve_rpc_torch.py`` on the CPU at test size: endpoint
    processes with endpoint 0 SIGKILLed midway, or endpoints on threads."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "serve_rpc_torch.py"),
         "--device", "cpu", "--dataset", "tiny", "--scale", "1",
         "--requests", "40", *mode],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=WAIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served 40/40" in proc.stdout and "errors 0" in proc.stdout
    if mode == ["--kill-endpoint"]:
        assert "healthy at exit: [1]" in proc.stdout, proc.stdout
