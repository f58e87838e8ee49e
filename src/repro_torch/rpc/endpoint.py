"""Server side of the transport: one process hosting one fabric worker
(port of ``repro.rpc.endpoint``).

A :class:`WorkerEndpoint` owns its OWN engine + cache-generation replica
(built from the same ``EngineConfig`` JSON the coordinator holds, with the
same seeded rng streams — generation 0 and the per-worker sampling rng are
therefore bitwise-identical to the in-proc fabric's, which is what makes
``transport="tcp"`` results bitwise-equal to ``transport="inproc"``) and
mirrors the FabricWorker serve loop:

    recv REQUEST -> micro-batcher -> infer_prepare/infer_compute
    -> RESULT (+ one BATCH record per served batch)

plus a heartbeat thread (liveness + the worker's own beat age, so a stalled
compute loop is visible through a healthy TCP connection), REFRESH handling
(the coordinator's watchdog drives the refresh cadence; the endpoint's
compute loop begins the build, swaps it in between batches and ships the
new routing table back in a SWAPPED frame), and a STATS reply for
cross-host tenant aggregation.

**On a mesh** (``EngineConfig.mesh`` above one position) an endpoint is a
world of ``torch.distributed`` ranks (:func:`repro_torch.launch.mesh
.lead_world`): the process started below is rank 0, the leader, and spawns
the other ranks on the same device; every rank builds the mesh engine and
generation 0, and only the leader binds the socket and answers frames.  The
leader's compute loop sends every batch it samples to the other ranks over
a :class:`~repro_torch.launch.mesh.Channel` (ids, bucket, pinned
generation), as worker ``w`` of the in-process mesh fabric does; every
rank samples it with the same rng and group stamp and runs the same
forward, whose sharded K1 sums over the model axis.  Swaps and refresh
kickoffs happen on the same thread as sampling, announced by a ``POLL``
in the same command order, so every rank samples every batch against the
same generation; worker ``w``'s results are bit for bit those of worker
``w`` of the in-process mesh fabric.  After each forward the ranks agree
that all of them succeeded: a rank whose forward fails fails the batch's
requests on the leader with an error status.  A rank whose sampling fails
exits, since its rng no longer follows the leader's.  A SHUTDOWN stops
every rank; a rank that dies ends the world (its leader exits with code
1), and the other ranks exit with a killed leader.

Run one per host::

    python -m repro_torch.rpc.endpoint --config engine.json --index 0 --port 0

The replica runs on the GPU unless ``--device cpu`` is given; on a CUDA
device the kernels are built (or the built extension loaded) on every rank
before the endpoint announces itself, and a failed build exits non-zero.
``--restore DIR`` serves the parameters of a checkpoint (either package's
``save``).  ``--port 0`` binds an ephemeral port; the chosen one is
announced on stdout as ``GNS_ENDPOINT_READY host=... port=... index=...``
(on a mesh with ``world=N pids=...``, the other ranks' process ids) once
generation 0 is built on every rank.  The endpoint survives coordinator
disconnects (it keeps listening), so a rebooted coordinator re-adopts a
warm replica.  After a SHUTDOWN frame it prints one last line,
``GNS_ENDPOINT_LAUNCHES {json}``: each rank's launches of K1
(``cache_lookup_agg``) and K2 (``gather_agg``), their access paths, its
live generation and a digest of its routing table, and the launches
summed over the ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import socket
import sys
import threading
import time
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import guarded_by
from repro_torch.launch.mesh import (Channel, MeshDesync, failed_ranks,
                                     new_host_group)
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.metrics import BatchRecord, ServeMeter

from . import wire

WORLD_TIMEOUT_S = 300.0     # bounds a world's rendezvous and collectives


@dataclasses.dataclass
class _EpPending:
    """One request in the endpoint's batcher (batcher contract: it reads
    ``node_ids`` and ``deadline``)."""
    req: int                          # coordinator correlation id
    node_ids: np.ndarray
    tenant: str
    t_recv: float                     # endpoint-local monotonic receipt
    deadline: Optional[float]         # endpoint-local monotonic absolute


@guarded_by("_esend", "_ep_conn")
@guarded_by("_elock", "_refresh_ask", writes_only=("ep_last_beat",))
class WorkerEndpoint:
    """One remote fabric worker: engine replica + serve loop + transport.

    ``_ep_conn`` (the live coordinator connection) is guarded by the send
    lock ``_esend`` — every frame write and the accept/EOF swaps happen
    under it.  ``ep_last_beat`` follows the FabricWorker writes_only
    contract: written under ``_elock`` once per loop, read lock-free by the
    heartbeat thread.  ``_refresh_ask`` (the last REFRESH's version, boxed)
    passes from the receiving thread to the compute loop under ``_elock``.

    On a mesh every rank builds its endpoint, in one order (the command
    channel's group is made here); the leader serves, the others
    :meth:`follow`.
    """

    def __init__(self, engine, index: int = 0, *, host: str = "127.0.0.1",
                 port: int = 0, heartbeat_ms: float = 100.0):
        self.engine = engine
        self.index = index
        self.group = index              # DP group / home shard, as in-proc
        self.host = host
        self.port = port
        self.heartbeat_ms = heartbeat_ms
        serve_cfg = engine.cfg.serve_config()
        self.serve_cfg = serve_cfg
        self.batcher = MicroBatcher(
            serve_cfg.buckets, max_wait_s=serve_cfg.max_wait_ms * 1e-3,
            max_queue=max(serve_cfg.max_queue, 2 * len(serve_cfg.buckets)))
        self.meter = ServeMeter(latency_window=serve_cfg.latency_window)
        # same rng streams as the in-proc fabric: worker sampling rng and
        # the refresh/cold-start rng — bitwise generation parity
        self._rng = np.random.default_rng(engine.cfg.seed + 0xFAB0 + index)
        self._refresh_rng = np.random.default_rng(engine.cfg.seed + 0x5E12)
        self._esend = threading.Lock()
        self._ep_conn: Optional[socket.socket] = None
        self._elock = threading.Lock()
        self.ep_last_beat = time.monotonic()
        self._refresh_ask: Optional[tuple] = None
        self._building = False          # compute loop only: a build begun
                                        # and not yet swapped in
        self.stall_s = 0.0              # chaos hook: sleep mid-batch
        self._stop_ev = threading.Event()
        self._lsock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._accept: Optional[threading.Thread] = None
        self.mesh = engine.mesh
        self.channel: Optional[Channel] = None
        if self.mesh is not None:
            self.channel = Channel(new_host_group(self.mesh.timeout),
                                   self.batcher.capacity)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def bind(self) -> int:
        """Bind + listen; returns the (possibly ephemeral) port."""
        assert self._lsock is None, "endpoint already bound"
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(2)
        self._lsock = s
        self.port = s.getsockname()[1]
        return self.port

    def warm(self) -> None:
        """Build generation 0 (on a mesh every rank calls it)."""
        self.engine.ensure_cache(self._refresh_rng)

    def start(self) -> "WorkerEndpoint":
        """Warm the replica (generation 0) and start the serve threads."""
        if self._lsock is None:
            self.bind()
        if not self._threads:
            self.warm()
            for target, name in ((self._compute_loop, "compute"),
                                 (self._hb_loop, "heartbeat")):
                t = threading.Thread(
                    target=target, daemon=True,
                    name=f"gns-endpoint-{self.index}-{name}")
                t.start()
                self._threads.append(t)
        return self

    def serve_forever(self) -> None:
        """Accept loop: one coordinator at a time, reconnects welcome.  On
        a mesh it returns after the other ranks were told to stop."""
        self.start()
        self._lsock.settimeout(0.2)
        try:
            while not self._stop_ev.is_set():
                try:
                    conn, _addr = self._lsock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._handle(conn)
        finally:
            self.stop()
            for t in self._threads:
                # the compute loop's last command is every rank's STOP
                t.join(timeout=None if self.channel is not None else 5.0)

    def serve_in_thread(self) -> threading.Thread:
        """Test/bench helper: run :meth:`serve_forever` on a daemon thread."""
        if self._lsock is None:
            self.bind()
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name=f"gns-endpoint-{self.index}-accept")
        t.start()
        self._accept = t
        return t

    def stop(self) -> None:
        self._stop_ev.set()
        ls, self._lsock = self._lsock, None
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        with self._esend:
            conn, self._ep_conn = self._ep_conn, None
        if conn is not None:
            try:
                # a close alone does not wake the recv blocked on it
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def join(self, timeout: Optional[float] = 30.0) -> bool:
        """After :meth:`stop`: wait for the endpoint's threads (accept,
        compute, heartbeat) and its store's generation build in flight to
        end; True when all have.  Call it before the interpreter exits:
        a daemon thread still inside a torch call while the process tears
        down aborts it ("terminate called without an active exception")."""
        threads = ([self._accept] if self._accept is not None else []) \
            + list(self._threads)
        for t in threads:
            t.join(timeout)
        store = self.engine.store
        built = store is None or store.join_build(timeout)
        return built and not any(t.is_alive() for t in threads)

    # ------------------------------------------------------------------
    # transport
    # ------------------------------------------------------------------
    def _send(self, kind: int, meta=None, arrays=None) -> bool:
        """Ship one frame to the connected coordinator; False = no
        connection (the frame is dropped — results for a vanished
        coordinator are reclaimed on ITS side by the watchdog)."""
        with self._esend:
            conn = self._ep_conn
            if conn is None:
                return False
            try:
                n = wire.send_frame(conn, kind, meta, arrays)
            except OSError:
                self._ep_conn = None
                try:
                    conn.close()
                except OSError:
                    pass
                return False
            self.meter.traffic.bytes_rpc_tx += n
            return True

    def wire_tx(self) -> int:
        """``bytes_rpc_tx``, read under the send lock: ``_send`` books a
        frame under that lock once its write has returned, so a frame the
        coordinator has received is counted here (a read without the lock
        can run between the write and the booking)."""
        with self._esend:
            return self.meter.traffic.bytes_rpc_tx

    def _handle(self, conn: socket.socket) -> None:
        with self._esend:
            self._ep_conn = conn
        try:
            while not self._stop_ev.is_set():
                kind, meta, arrays, n = wire.recv_frame(conn)
                self.meter.traffic.bytes_rpc_rx += n
                self._dispatch(kind, meta, arrays)
                if kind == wire.SHUTDOWN:
                    self._stop_ev.set()
                    return
        except (wire.ChannelClosed, wire.FrameError, OSError):
            pass                  # coordinator went away: back to accept()
        finally:
            with self._esend:
                if self._ep_conn is conn:
                    self._ep_conn = None
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, kind: int, meta: dict, arrays: dict) -> None:
        if kind == wire.REQUEST:
            now = time.monotonic()
            dl_ms = meta.get("deadline_ms")
            p = _EpPending(
                req=int(meta["req"]),
                # copy out of the recv buffer (the frame buffer is reused)
                node_ids=np.array(arrays["ids"], dtype=np.int64),
                tenant=str(meta.get("tenant", "default")),
                t_recv=now,
                deadline=now + dl_ms * 1e-3 if dl_ms is not None else None)
            self.meter.observe_submit(p.tenant)
            if not self.batcher.offer(p):
                self.meter.observe_reject(p.tenant)
                self._send(wire.RESULT, {
                    "req": p.req, "status": "error",
                    "error": "endpoint batcher at capacity"})
        elif kind == wire.HELLO:
            md, arrs = self._table_frame()
            md["rpc_id"] = meta.get("rpc_id")
            md["capacity"] = self.batcher.capacity
            md["index"] = self.index
            self._send(wire.HELLO_ACK, md, arrs)
        elif kind == wire.REFRESH:
            # begun by the compute loop, the one thread that samples and
            # swaps (on a mesh, the one that speaks to the other ranks)
            with self._elock:
                self._refresh_ask = (meta.get("version"),)
        elif kind == wire.STATS_REQ:
            self._send(wire.STATS, {
                "rpc_id": meta.get("rpc_id"), "index": self.index,
                "tenants": self.meter.tenant_snapshot(),
                "counters": {
                    "served": self.meter.snapshot().get("served", 0),
                    "bytes_rpc_tx": self.meter.traffic.bytes_rpc_tx,
                    "bytes_rpc_rx": self.meter.traffic.bytes_rpc_rx,
                }})
        # SHUTDOWN is handled by the recv loop; unknown-but-valid kinds are
        # ignored (forward compatibility)

    def _table_frame(self):
        store = self.engine.store
        table = store.routing_table() if store is not None else None
        md, arrs = wire.pack_table(table)
        md["version"] = store.version if store is not None else -1
        return md, arrs

    # ------------------------------------------------------------------
    # generation maintenance (the compute loop's, on every rank alike)
    # ------------------------------------------------------------------
    def _maintain(self) -> None:
        """Publish a finished build (SWAPPED to the coordinator), then
        begin the one the last REFRESH asked for.  On a mesh the leader
        first tells the other ranks, with a POLL, while a refresh is asked
        for or building (the store's swap and kickoff are agreements)."""
        with self._elock:
            ask, self._refresh_ask = self._refresh_ask, None
        version = ask[0] if ask is not None else None
        if self.channel is not None:
            if ask is None and not self._building:
                return
            self.channel.send(Channel.POLL, (ask is not None,
                                             version is not None,
                                             version or 0))
        self._maintain_store(ask is not None, version)

    def _maintain_store(self, due: bool, version: Optional[int]) -> None:
        store = self.engine.store
        if store is None:
            return
        try:
            if store.swap_if_ready():
                self._building = False
                self.meter.observe_swap()
                if self.mesh is None or self.mesh.leader:
                    md, arrs = self._table_frame()
                    self._send(wire.SWAPPED, md, arrs)
            if due and store.begin_refresh(
                    self._refresh_rng,
                    version=int(version) if version is not None
                    else store.version + 1):
                self._building = True
        except BaseException:
            self._building = False
            self.meter.observe_refresh_failure()

    # ------------------------------------------------------------------
    # serve loop (the FabricWorker._run shape, minus the scheduler pump —
    # weighted-fair order is applied coordinator-side before shipping)
    # ------------------------------------------------------------------
    def _hb_loop(self) -> None:
        hb_s = max(self.heartbeat_ms * 1e-3, 1e-3)
        while not self._stop_ev.wait(hb_s):
            now = time.monotonic()
            self._send(wire.HEARTBEAT, {
                "beat_age_s": max(now - self.ep_last_beat, 0.0),
                "backlog": self.batcher.qsize()})

    def _compute_loop(self) -> None:
        try:
            self._compute_batches()
        finally:
            if self.channel is not None:
                self.channel.send(Channel.STOP)

    def _compute_batches(self) -> None:
        while True:
            with self._elock:
                self.ep_last_beat = time.monotonic()
            self._maintain()
            batch = self.batcher.next_batch(timeout=0.02)
            if batch is None:
                if self._stop_ev.is_set():
                    return
                if self.channel is not None:
                    self.channel.send(Channel.HEARTBEAT)
                continue
            t_start = time.monotonic()
            live, expired = [], []
            for p in batch:
                (expired if p.deadline is not None and p.deadline < t_start
                 else live).append(p)
            for p in expired:
                self.meter.observe_expired(t_start - p.t_recv,
                                           tenant=p.tenant)
                self._send(wire.RESULT, {
                    "req": p.req, "status": "expired",
                    "queue_wait_s": t_start - p.t_recv,
                    "remote_total_s": t_start - p.t_recv})
            if not live:
                continue
            try:
                self._serve_batch(live, t_start)
            except BaseException as e:
                self.meter.observe_error(len(live))
                for p in live:
                    self._send(wire.RESULT, {
                        "req": p.req, "status": "error", "error": repr(e)})
            if self._stop_ev.is_set() and self.batcher.qsize() == 0:
                return

    def _prepare(self, ids: np.ndarray, bucket: int):
        """Sample one batch with this worker's rng and group stamp."""
        eng = self.engine
        store = eng.store
        if store is None:
            return eng.infer_prepare(ids, bucket=bucket, rng=self._rng)
        store.dp_group = self.group
        with store.serving(self.meter.traffic):
            return eng.infer_prepare(ids, bucket=bucket, rng=self._rng)

    def _failed_forward(self, err: Optional[BaseException]) -> list:
        """On a mesh: the ranks whose forward failed (every rank calls
        it); a failure of this rank is written to stderr with its
        traceback."""
        if err is not None:
            sys.stderr.write(f"endpoint {self.index} rank {self.mesh.rank}: "
                             f"the forward failed:\n" + "".join(
                                 traceback.format_exception(err)))
            sys.stderr.flush()
        return failed_ranks(err is None, self.channel.group)

    def _serve_batch(self, live: List[_EpPending], t_start: float) -> None:
        eng = self.engine
        ids = np.concatenate([p.node_ids for p in live])
        bucket = self.batcher.bucket_for(len(ids))
        t0 = time.perf_counter()
        mb = self._prepare(ids, bucket)
        if self.stall_s:
            time.sleep(self.stall_s)    # chaos hook: remote in-flight stall
        version = mb.cache_version
        if self.channel is not None:    # the batch, on every rank
            self.channel.send(Channel.BATCH, (bucket, version, 0, len(live)),
                              ids)
        err, logits = None, None
        try:
            logits = eng.infer_compute(mb, meter=self.meter.traffic)
        except BaseException as e:
            err = e
        if self.channel is not None:
            bad = self._failed_forward(err)
            if bad and err is None:
                raise RuntimeError(f"ranks {bad} of endpoint {self.index}'s "
                                   f"world failed the forward")
        if err is not None:
            raise err
        compute_s = time.perf_counter() - t0
        t_done = time.monotonic()
        rec = {"bucket": bucket, "n_requests": len(live), "n_ids": len(ids),
               "compute_s": compute_s, "cache_version": version,
               "hit_fraction": mb.num_cached / max(mb.num_input, 1)}
        self.meter.observe_batch(BatchRecord(**rec), worker=self.index)
        self._send(wire.BATCH, rec)
        lo = 0
        for p in live:
            n = len(p.node_ids)
            qw = t_start - p.t_recv
            self.meter.observe_request(
                qw, compute_s, t_done - p.t_recv, tenant=p.tenant,
                late=p.deadline is not None and t_done > p.deadline)
            self._send(wire.RESULT, {
                "req": p.req, "status": "ok", "queue_wait_s": qw,
                "compute_s": compute_s, "remote_total_s": t_done - p.t_recv,
                "bucket": bucket, "cache_version": version},
                {"logits": logits[lo:lo + n]})
            lo += n

    # ------------------------------------------------------------------
    # the other ranks of a mesh
    # ------------------------------------------------------------------
    def follow(self) -> None:
        """A rank other than the leader: run the leader's commands in its
        order (batches, the store's maintenance) until its STOP."""
        while True:
            kind, fields, ids = self.channel.recv()
            if kind == Channel.STOP:
                return
            if kind == Channel.POLL:
                due, given, version = fields[:3]
                self._maintain_store(bool(due), version if given else None)
            elif kind == Channel.BATCH:
                bucket, version, _, n_requests = fields
                self._follow_batch(ids, bucket, version, n_requests)

    def _follow_batch(self, ids: np.ndarray, bucket: int, version: int,
                      n_requests: int) -> None:
        """One of the leader's batches.  A forward that fails fails the
        batch (the leader answers its requests with an error status) and
        the world goes on: no state outlives a forward.  A failed
        sampling raises, which ends this rank and so the world (its
        leader's watch exits within 0.1 s): its sampling rng no longer
        follows the leader's."""
        mb = self._prepare(ids, bucket)
        if mb.cache_version != version:
            raise MeshDesync(f"rank {self.mesh.rank} sampled generation "
                             f"{mb.cache_version}, the leader {version}")
        err = None
        t0 = time.perf_counter()
        try:
            self.engine.infer_compute(mb, meter=self.meter.traffic)
        except Exception as e:
            err = e
            self.meter.observe_error(1)
        if not self._failed_forward(err):
            self.meter.observe_batch(BatchRecord(
                bucket=bucket, n_requests=n_requests, n_ids=len(ids),
                compute_s=time.perf_counter() - t0, cache_version=version,
                hit_fraction=mb.num_cached / max(mb.num_input, 1)),
                worker=self.index)

    def record(self) -> dict:
        """This rank's launches (:func:`launch_counts`), batches served,
        the sharded K1's all_reduces and their ms (``kernels.ops
        .psum_clock``), live generation and routing-table digest
        (:func:`table_digest`)."""
        from repro_torch.kernels.ops import psum_clock
        store = self.engine.store
        rank = self.mesh.rank if self.mesh is not None else 0
        calls, ms = psum_clock.read()
        return {"rank": rank, **launch_counts(),
                "batches": self.meter.batch_count(), "psum_calls": calls,
                "psum_ms": ms,
                "version": store.version if store is not None else -1,
                "table": table_digest(store.routing_table()
                                      if store is not None else None)}

    def gather_records(self) -> list:
        """Every rank's :meth:`record`, in rank order (on a mesh every
        rank calls it, after the serve loop ended)."""
        if self.mesh is None:
            return [self.record()]
        out = [None] * self.mesh.size
        dist.all_gather_object(out, self.record(),
                               group=self.mesh.host_group)
        return out


# ---------------------------------------------------------------------------
# process entrypoint
# ---------------------------------------------------------------------------

LAUNCHES_TAG = "GNS_ENDPOINT_LAUNCHES"
READY_TAG = "GNS_ENDPOINT_READY"


def launch_counts() -> dict:
    """This process's K1 and K2 launches and their access paths."""
    from repro_torch.kernels import cache_lookup, gather_agg
    return {"cache_lookup_agg": cache_lookup.launches.value,
            "gather_agg": gather_agg.launches.value,
            "k1_paths": {p: c.value
                         for p, c in cache_lookup.path_calls.items()},
            "k2_paths": {p: c.value
                         for p, c in gather_agg.path_calls.items()}}


def table_digest(table) -> Optional[str]:
    """SHA-256 of a routing table as the wire carries it (None: none)."""
    if table is None:
        return None
    md, arrs = wire.pack_table(table)
    h = hashlib.sha256(json.dumps(md, sort_keys=True).encode())
    h.update(np.ascontiguousarray(arrs["shard_of_node"]).tobytes())
    return h.hexdigest()


def build_endpoint(cfg, opts: dict, mesh=None) -> WorkerEndpoint:
    """One rank's endpoint: the engine on ``opts["device"]`` (on ``mesh``),
    the checkpoint's parameters when ``opts["restore"]`` names one, the
    kernels loaded on a CUDA device, generation 0 built."""
    from repro_torch.gns.engine import GNSEngine
    engine = GNSEngine(cfg, device=opts["device"], mesh=mesh)
    if opts.get("restore"):
        engine.restore(opts["restore"])
    if engine.device.type == "cuda":
        # build (or load the built) kernels before announcing: a replica
        # that cannot launch them must not serve through the plain versions
        from repro_torch.kernels._ext import load_kernels
        load_kernels()
    ep = WorkerEndpoint(engine, opts["index"], host=opts["host"],
                        port=opts["port"], heartbeat_ms=opts["heartbeat_ms"])
    ep.warm()
    return ep


def _follower(mesh, device, cfg_dict: dict, opts: dict) -> None:
    """A rank other than the leader of an endpoint's world (on the
    leader's device, ``opts["device"]``)."""
    from repro_torch.gns.config import EngineConfig
    ep = build_endpoint(EngineConfig.from_dict(cfg_dict), opts, mesh)
    dist.barrier(group=mesh.host_group)       # every rank is warm
    ep.follow()
    ep.gather_records()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="GNS fabric worker endpoint (one per host)")
    ap.add_argument("--config", required=True,
                    help="EngineConfig JSON file (the coordinator's config)")
    ap.add_argument("--index", type=int, default=0,
                    help="worker index = DP group = home shard")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (announced on stdout)")
    ap.add_argument("--heartbeat-ms", type=float, default=100.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the replica (default: the GPU)")
    ap.add_argument("--restore", default=None,
                    help="checkpoint directory whose parameters to serve")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.gns.config import EngineConfig
    with open(args.config) as f:
        cfg_dict = json.load(f)
    cfg = EngineConfig.from_dict(cfg_dict)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    opts = {"device": str(device), "index": args.index, "host": args.host,
            "port": args.port, "heartbeat_ms": args.heartbeat_ms,
            "restore": args.restore}
    world, mesh, extra = None, None, ""
    if cfg.mesh is not None and cfg.mesh.data * cfg.mesh.model > 1:
        from repro_torch.launch.mesh import lead_world
        if device.type == "cuda":
            from repro_torch.kernels._ext import load_kernels
            load_kernels()            # built once, before the ranks load it
        world = lead_world("repro_torch.rpc.endpoint:_follower",
                           data=cfg.mesh.data, model=cfg.mesh.model,
                           device=device, backend="gloo",
                           args=(cfg_dict, opts), timeout_s=WORLD_TIMEOUT_S)
        mesh = world.mesh
        extra = (f" world={mesh.size} pids="
                 + ",".join(str(p) for p in world.pids))
    ep = build_endpoint(cfg, opts, mesh)
    if world is not None:
        dist.barrier(group=mesh.host_group)   # every rank is warm
    port = ep.bind()
    print(f"{READY_TAG} host={args.host} port={port} "
          f"index={args.index}{extra}", flush=True)
    ep.serve_forever()
    ranks = ep.gather_records()
    total = {k: sum(r[k] for r in ranks)
             for k in ("cache_lookup_agg", "gather_agg")}
    for k in ("k1_paths", "k2_paths"):
        total[k] = {p: sum(r[k][p] for r in ranks) for p in ranks[0][k]}
    print(f"{LAUNCHES_TAG} " + json.dumps(
        {"index": args.index, **total, "ranks": ranks}), flush=True)
    if world is not None:
        codes = world.close()
        if any(codes):
            print(f"endpoint {args.index}: ranks exited with {codes}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
