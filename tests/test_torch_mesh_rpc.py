"""``ServeFabric(transport="tcp")`` over mesh endpoints on the CPU: each
endpoint is ``python -m repro_torch.rpc.endpoint --device cpu`` on the
reference's CI rpc-smoke config (``tests/test_rpc_fabric.py``'s
``_smoke_config``: a (2, 2) mesh, fused input, locality placement,
fanouts (3, 4), batch 32, hidden 16), a world of four gloo ranks that its
process leads.  One scenario for every test here, the lock sanitizer armed
in every process:

* endpoints A0 and A1 serve the reference's parameters (a checkpoint of
  its meshless engine with 2 cache shards) to the port's coordinator, one
  process as the reference's is (``GNSEngine.coordinator`` of the mesh
  config: no process group, no child process): requests pinned to a
  worker, one at a time, match the reference's meshless fabric (same
  bucket and generation, logits within rtol 1e-4 / atol 1e-4) and the
  port's inproc fabric on a (2, 2) world bit for bit; then a refresh
  after 4 batches, which every rank of an endpoint swaps in; then the
  reference smoke's traffic, and A0's leader is SIGKILLed;
* then endpoints B0 and B1 are driven by the reference's own
  coordinator (``RPC_COORD_CODE``, jax on 4 forced host devices), which
  SIGKILLs B0;
* the killed endpoints' other ranks exit within 30 s; the survivors'
  SHUTDOWN gathers every rank's generation and routing-table digest.

Apart from that scenario, an endpoint world served in a spawn of ranks
fails a batch whose forward one of its followers fails, and serves the
next; a follower that fails to sample ends the world.

Every wait has a deadline.  Ephemeral ports on 127.0.0.1 only.
"""
import dataclasses
import json
import os
import pickle
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_rpc_fabric import RPC_COORD_CODE, _smoke_config  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import FabricConfig as FabricConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.serve import ServeFabric as ServeFabricRef  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.rpc import wire  # noqa: E402
from repro_torch.rpc.endpoint import (LAUNCHES_TAG, READY_TAG,  # noqa: E402
                                      table_digest)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
WAIT_S = 120.0
EXIT_S = 30.0                 # a killed leader's ranks must be gone by then
PINNED = [(0, 5), (1, 3), (0, 12), (1, 20), (1, 7)]     # (worker, ids)


class _Endpoint:
    """One endpoint world's leader process; its stdout lines are read by
    a daemon thread, and the moment it is seen dead is recorded."""

    def __init__(self, cfg_path: Path, index: int, name: str, env: dict,
                 restore=None):
        self.err_path = cfg_path.parent / f"{name}.err"
        extra = ["--restore", str(restore)] if restore else []
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.rpc.endpoint",
                 "--config", str(cfg_path), "--index", str(index),
                 "--port", "0", "--heartbeat-ms", "50", "--device", "cpu",
                 *extra],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err,
                text=True)
        self.lines: queue.Queue = queue.Queue()
        self.pids: list = []
        self.t_dead = self.t_gone = None
        threading.Thread(target=self._pump, daemon=True).start()
        threading.Thread(target=self._watch, daemon=True).start()

    def _pump(self):
        # the other ranks hold the pipe too: EOF comes after the last
        with self.proc.stdout:
            for line in self.proc.stdout:
                self.lines.put(line)
        self.lines.put(None)

    def _watch(self):
        """When the leader dies, then when its last rank is gone (or the
        bound of that wait passed)."""
        while self.proc.poll() is None:
            time.sleep(0.02)
        self.t_dead = time.time()
        while time.time() < self.t_dead + 2 * EXIT_S and not (
                self.pids and all(_gone(p) for p in self.pids)):
            time.sleep(0.02)
        self.t_gone = time.time()

    def line(self, tag: str) -> str:
        deadline = time.monotonic() + WAIT_S
        while True:
            try:
                line = self.lines.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                line = None
            assert line is not None, (tag, self.proc.poll(),
                                      self.err_path.read_text()[-3000:])
            if line.startswith(tag):
                return line.strip()

    def ready(self) -> None:
        kv = dict(f.split("=") for f in self.line(READY_TAG).split()[1:])
        self.port = int(kv["port"])
        self.pids = [int(p) for p in kv["pids"].split(",")]
        self.world = int(kv["world"])

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def shutdown(self) -> dict:
        with socket.create_connection(("127.0.0.1", self.port),
                                      timeout=WAIT_S) as sock:
            wire.send_frame(sock, wire.SHUTDOWN)
        rec = json.loads(self.line(LAUNCHES_TAG).removeprefix(LAUNCHES_TAG))
        rec["exit"] = self.proc.wait(timeout=WAIT_S)
        return rec

    def reap(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=WAIT_S)


def _gone(pid: int) -> bool:
    """The process has exited (gone, or a zombie nobody reaped yet)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except (FileNotFoundError, ProcessLookupError):
        return True


def _followers_exit(ep: _Endpoint) -> dict:
    """The killed leader's exit code and the seconds from its death to
    its last rank's exit."""
    deadline = time.monotonic() + WAIT_S
    while ep.t_gone is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ep.t_gone is not None, "the leader was not killed"
    return {"code": ep.proc.returncode, "exit_s": ep.t_gone - ep.t_dead,
            "left": [p for p in ep.pids if not _gone(p)]}


def _reference_meshless(smoke: dict, ckpt: Path) -> tuple:
    """``PINNED`` requests (ids drawn from a seed) one at a time through
    the reference's fabric on the smoke config without a mesh, its cache
    padded to 2 shards (the mesh's layout); its parameters are saved to
    ``ckpt`` for every port engine here."""
    cfg = EngineConfigRef.from_dict(smoke)
    cfg = dataclasses.replace(cfg, mesh=None, cache=dataclasses.replace(
        cfg.cache, shards=2))
    ref = EngineRef(cfg)
    ref.save(ckpt, step=0)
    rng = np.random.default_rng(4)
    pinned = [(w, rng.choice(ref.ds.graph.num_nodes, n, replace=False))
              for w, n in PINNED]
    with ServeFabricRef(ref, cfg=FabricConfigRef(
            workers=2, stall_timeout_ms=600_000.0)) as fab:
        return pinned, [fab.submit(ids, worker=w).result(timeout=600)
                        for w, ids in pinned]


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_rpc")
    smoke = _smoke_config()
    cfg_path = tmp / "engine.json"
    cfg_path.write_text(json.dumps(smoke))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_LOCK_SANITIZER="1", OMP_NUM_THREADS="1")
    eps = {}
    try:
        # one endpoint world starting at a time (fewer busy ranks at once)
        ckpt = tmp / "ckpt"
        pinned, want = _reference_meshless(smoke, ckpt)
        for i in range(2):
            eps[f"A{i}"] = _Endpoint(cfg_path, i, f"A{i}", env, ckpt)
            eps[f"A{i}"].ready()
        spec = {"cfg": json.dumps(smoke), "restore": str(ckpt),
                "pinned": pinned, "pid0": eps["A0"].proc.pid,
                "endpoints": [eps["A0"].address, eps["A1"].address]}
        ranks = run_ranks("_torch_mesh_ranks:inproc_pinned_ranks", data=2,
                          model=2, devices=["cpu"] * 4, backend="gloo",
                          args=(spec,), timeout_s=WAIT_S * 2)
        spec_path, out_path = tmp / "coord_spec.pkl", tmp / "coord_out.pkl"
        spec_path.write_bytes(pickle.dumps(spec))
        coord = subprocess.run(
            [sys.executable, str(REPO / "tests" / "_torch_mesh_ranks.py"),
             str(spec_path), str(out_path)], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=WAIT_S * 2)
        assert coord.returncode == 0, coord.stderr[-4000:]
        port = pickle.loads(out_path.read_bytes())
        for i in range(2):
            eps[f"B{i}"] = _Endpoint(cfg_path, i, f"B{i}", env)
            eps[f"B{i}"].ready()
        b = eps["B0"], eps["B1"]
        coord = subprocess.run(
            [sys.executable, "-c", RPC_COORD_CODE.format(
                cfg_path=str(cfg_path), port0=b[0].port, port1=b[1].port,
                pid0=b[0].proc.pid)],
            cwd=REPO, capture_output=True, text=True, timeout=WAIT_S * 2,
            env=dict(env, JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        b_alive = eps["B1"].proc.poll() is None
        exits = {k: _followers_exit(eps[k]) for k in ("A0", "B0")}
        records = {k: eps[k].shutdown() for k in ("A1", "B1")}
        return {"want": want, "pinned": pinned, "ranks": ranks, "port": port,
                "ref_coord": (coord.returncode, coord.stdout,
                              coord.stderr[-4000:]),
                "b1_alive": b_alive, "exits": exits, "records": records,
                "worlds": {k: ep.world for k, ep in eps.items()}}
    finally:
        for ep in eps.values():
            ep.reap()


def test_pinned_requests_match_reference_meshless_fabric(scenario):
    got = scenario["port"]["tcp"]
    assert len(got) == len(PINNED)
    for (status, bucket, version, logits), r, (_, ids) in zip(
            got, scenario["want"], scenario["pinned"]):
        assert status == r.status == "ok"
        assert (bucket, version) == (r.bucket, r.cache_version)
        assert logits.shape == (len(ids), np.asarray(r.logits).shape[1])
        np.testing.assert_allclose(logits, np.asarray(r.logits), **TOL)


def test_pinned_requests_equal_the_inproc_mesh_fabric(scenario):
    tcp, inproc = scenario["port"]["tcp"], scenario["ranks"][0]["inproc"]
    assert len(tcp) == len(inproc) == len(PINNED)
    for (s, b, v, x), (s2, b2, v2, x2) in zip(tcp, inproc):
        assert (s, b, v) == (s2, b2, v2)
        np.testing.assert_array_equal(x, x2)


def test_reference_smoke_assertions_on_the_port_coordinator(scenario):
    """``RPC_COORD_CODE``'s asserts, the port's coordinator one process."""
    lead = scenario["port"]
    assert lead["smoke_status"] == ["ok"] * 50
    assert lead["smoke_healthy"] == [1]
    assert lead["smoke_remote"] == [1]
    snap = lead["smoke_snapshot"]
    rt = snap["routing"]
    assert rt["routed_known_ids"] > 0, rt
    assert rt["route_local_fraction"] > 0.5, rt
    assert rt["failovers"] >= 1 and rt["retries"] >= 1, rt
    assert snap["errors"] == 0, snap
    assert snap["rpc"]["bytes_rpc_tx"] > 0 and snap["rpc"]["bytes_rpc_rx"] > 0
    assert "rpc_wait_p99_ms" in snap, sorted(snap)


def test_reference_coordinator_drives_mesh_endpoints(scenario):
    code, out, err = scenario["ref_coord"]
    assert code == 0, err
    assert "RPC_SMOKE_OK" in out, out[-3000:]
    assert scenario["exits"]["B0"]["code"] == -signal.SIGKILL
    assert scenario["b1_alive"]
    assert scenario["records"]["B1"]["exit"] == 0


def test_refresh_lands_on_every_rank_of_an_endpoint(scenario):
    """The watchdog's REFRESH after 4 batches: each endpoint swaps, the
    batches after it pin the new generation, and the survivor's four
    ranks end on one generation whose routing table is the one its
    SWAPPED frame carried."""
    ref = scenario["port"]["refresh"]
    assert ref["status"] == ["ok"] * 6 and ref["errors"] == 0
    assert ref["versions"] == [0, 0, 0, 0, 1, 1]
    swapped = {i: (v, d) for i, v, d in ref["swapped"]}
    assert sorted(swapped) == [0, 1] and len(ref["swapped"]) == 2
    ranks = scenario["records"]["A1"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert {r["version"] for r in ranks} == {1}
    assert {r["table"] for r in ranks} == {swapped[1][1]}
    assert swapped[1][0] == 1
    b1 = scenario["records"]["B1"]["ranks"]
    assert len({(r["version"], r["table"]) for r in b1}) == 1


def test_killed_endpoint_ranks_exit_within_30_s(scenario):
    for name in ("A0", "B0"):
        ex = scenario["exits"][name]
        assert ex["code"] == -signal.SIGKILL, (name, ex)
        assert not ex["left"] and ex["exit_s"] < EXIT_S, (name, ex)


def test_endpoints_are_worlds_and_the_coordinator_leads_its_own(scenario):
    assert set(scenario["worlds"].values()) == {4}
    for name in ("A1", "B1"):
        rec = scenario["records"][name]
        assert rec["exit"] == 0 and len(rec["ranks"]) == 4
        assert rec["cache_lookup_agg"] == rec["gather_agg"] == 0   # the CPU
        # every rank ran every batch, its sharded K1 summing over the
        # model axis
        assert len({(r["batches"], r["psum_calls"])
                    for r in rec["ranks"]}) == 1
        assert rec["ranks"][0]["batches"] > 0
        assert rec["ranks"][0]["psum_calls"] > 0
        assert all(r["psum_ms"] > 0 for r in rec["ranks"])   # always timed
    # the port's coordinator: one process, as the reference's, on the
    # config's 2 cache shards; no process group, no child process
    port = scenario["port"]
    assert port["tcp_workers"] == 2
    assert port["mesh"] is None and port["shards"] == 2
    assert not port["dist"] and port["children"] == []
    # a tcp fabric over the (2, 2) mesh engine is refused on every rank;
    # its inproc fabric takes requests on the leader only
    ranks = scenario["ranks"]
    assert all(r["tcp_refused"] for r in ranks)
    assert all(r["refused"] for r in ranks[1:])
    assert "inproc" not in ranks[1]


def test_a_follower_that_fails_a_forward_fails_its_batch():
    """Rank 1 of an endpoint world fails its second forward: that
    request comes back with the endpoint's error status naming the rank,
    and the world serves the next one."""
    rng = np.random.default_rng(9)
    spec = {"cfg": json.dumps(_smoke_config()),
            "requests": [rng.choice(2000, 4, replace=False)
                         for _ in range(3)]}
    ranks = run_ranks("_torch_mesh_ranks:endpoint_fault_ranks", data=2,
                      model=2, devices=["cpu"] * 4, backend="gloo",
                      args=(spec,), timeout_s=WAIT_S * 2)
    lead = ranks[0]
    assert lead["outcome"][0] == lead["outcome"][2] == "ok"
    assert "ranks [1] of endpoint 0's world failed the forward" in \
        lead["outcome"][1]
    assert lead["errors"] == 1
    assert [r["batches"] for r in ranks] == [2, 2, 2, 2]   # not the failed


def test_a_follower_that_fails_sampling_ends_the_world():
    """Rank 1 of an endpoint world fails to sample its second batch: its
    rng no longer follows the leader's, so the rank raises and the world
    ends, rather than serving on."""
    rng = np.random.default_rng(9)
    spec = {"cfg": json.dumps(_smoke_config()), "fault": "sampling",
            "requests": [rng.choice(2000, 4, replace=False)
                         for _ in range(3)]}
    with pytest.raises(RuntimeError,
                       match="rank 1 failed(.|\n)*injected sampling fault"):
        run_ranks("_torch_mesh_ranks:endpoint_fault_ranks", data=2,
                  model=2, devices=["cpu"] * 4, backend="gloo",
                  args=(spec,), timeout_s=WAIT_S * 2)


def test_table_digest_is_the_wire_tables():
    from repro_torch.featurestore.placement import RoutingTable
    t = RoutingTable(shard_of_node=np.array([0, 1, -1, 1], np.int16),
                     n_shards=2, version=3)
    same = wire.unpack_table(*wire.pack_table(t))
    assert table_digest(t) == table_digest(same)
    other = dataclasses.replace(t, version=4)
    assert table_digest(other) != table_digest(t)
    assert table_digest(None) is None
