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
(the coordinator's watchdog drives the refresh cadence; the endpoint swaps
locally and ships the new routing table back in a SWAPPED frame), and a
STATS reply for cross-host tenant aggregation.

Run one per host::

    python -m repro_torch.rpc.endpoint --config engine.json --index 0 --port 0

The replica runs on the GPU unless ``--device cpu`` is given; on a CUDA
device the kernels are built (or the built extension loaded) before the
endpoint announces itself, and a failed build exits non-zero.  ``--port 0``
binds an ephemeral port; the chosen one is announced on stdout as
``GNS_ENDPOINT_READY host=... port=... index=...`` before serving.  The
endpoint survives coordinator disconnects (it keeps listening), so a
rebooted coordinator re-adopts a warm replica.  After a SHUTDOWN frame, an
endpoint on the GPU prints one last line, ``GNS_ENDPOINT_LAUNCHES {json}``:
this process's launches of K1 (``cache_lookup_agg``) and K2
(``gather_agg``) and their access paths.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.analysis import guarded_by
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.metrics import BatchRecord, ServeMeter

from . import wire


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
@guarded_by("_elock", writes_only=("ep_last_beat",))
class WorkerEndpoint:
    """One remote fabric worker: engine replica + serve loop + transport.

    ``_ep_conn`` (the live coordinator connection) is guarded by the send
    lock ``_esend`` — every frame write and the accept/EOF swaps happen
    under it.  ``ep_last_beat`` follows the FabricWorker writes_only
    contract: written under ``_elock`` once per loop, read lock-free by the
    heartbeat thread.
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
        self.stall_s = 0.0              # chaos hook: sleep mid-batch
        self._stop_ev = threading.Event()
        self._lsock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []

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

    def start(self) -> "WorkerEndpoint":
        """Warm the replica (generation 0) and start the serve threads."""
        if self._lsock is None:
            self.bind()
        if not self._threads:
            self.engine.ensure_cache(self._refresh_rng)
            for target, name in ((self._compute_loop, "compute"),
                                 (self._hb_loop, "heartbeat")):
                t = threading.Thread(
                    target=target, daemon=True,
                    name=f"gns-endpoint-{self.index}-{name}")
                t.start()
                self._threads.append(t)
        return self

    def serve_forever(self) -> None:
        """Accept loop: one coordinator at a time, reconnects welcome."""
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
                t.join(timeout=5.0)

    def serve_in_thread(self) -> threading.Thread:
        """Test/bench helper: run :meth:`serve_forever` on a daemon thread."""
        if self._lsock is None:
            self.bind()
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name=f"gns-endpoint-{self.index}-accept")
        t.start()
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
                conn.close()
            except OSError:
                pass

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
            self._begin_refresh(meta.get("version"))
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

    def _begin_refresh(self, version) -> None:
        store = self.engine.store
        if store is None or store.refreshing:
            return
        try:
            store.begin_refresh(
                self._refresh_rng,
                version=int(version) if version is not None
                else store.version + 1)
        except BaseException:
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

    def _poll_swap(self) -> None:
        store = self.engine.store
        if store is None:
            return
        try:
            if store.swap_if_ready():
                self.meter.observe_swap()
                md, arrs = self._table_frame()
                self._send(wire.SWAPPED, md, arrs)
        except BaseException:
            self.meter.observe_refresh_failure()

    def _compute_loop(self) -> None:
        while True:
            with self._elock:
                self.ep_last_beat = time.monotonic()
            self._poll_swap()
            batch = self.batcher.next_batch(timeout=0.02)
            if batch is None:
                if self._stop_ev.is_set():
                    return
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

    def _serve_batch(self, live: List[_EpPending], t_start: float) -> None:
        eng = self.engine
        ids = np.concatenate([p.node_ids for p in live])
        bucket = self.batcher.bucket_for(len(ids))
        t0 = time.perf_counter()
        store = eng.store
        if store is not None:
            store.dp_group = self.group
            with store.serving(self.meter.traffic):
                mb = eng.infer_prepare(ids, bucket=bucket, rng=self._rng)
        else:
            mb = eng.infer_prepare(ids, bucket=bucket, rng=self._rng)
        if self.stall_s:
            time.sleep(self.stall_s)    # chaos hook: remote in-flight stall
        logits = eng.infer_compute(mb, meter=self.meter.traffic)
        compute_s = time.perf_counter() - t0
        t_done = time.monotonic()
        version = mb.cache_version
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


# ---------------------------------------------------------------------------
# process entrypoint
# ---------------------------------------------------------------------------

LAUNCHES_TAG = "GNS_ENDPOINT_LAUNCHES"


def launch_counts() -> dict:
    """This process's K1 and K2 launches and their access paths."""
    from repro_torch.kernels import cache_lookup, gather_agg
    return {"cache_lookup_agg": cache_lookup.launches.value,
            "gather_agg": gather_agg.launches.value,
            "k1_paths": {p: c.value
                         for p, c in cache_lookup.path_calls.items()},
            "k2_paths": {p: c.value
                         for p, c in gather_agg.path_calls.items()}}


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
    args = ap.parse_args(argv)

    from repro_torch.gns.config import EngineConfig
    from repro_torch.gns.engine import GNSEngine
    with open(args.config) as f:
        cfg = EngineConfig.from_dict(json.load(f))
    engine = GNSEngine(cfg, device=args.device)
    on_card = engine.device.type == "cuda"
    if on_card:
        # build (or load the built) kernels before announcing: a replica
        # that cannot launch them must not serve through the plain versions
        from repro_torch.kernels._ext import load_kernels
        load_kernels()
    ep = WorkerEndpoint(engine, args.index, host=args.host, port=args.port,
                        heartbeat_ms=args.heartbeat_ms)
    port = ep.bind()
    print(f"GNS_ENDPOINT_READY host={args.host} port={port} "
          f"index={args.index}", flush=True)
    ep.serve_forever()
    if on_card:
        print(f"{LAUNCHES_TAG} " + json.dumps(
            {"index": args.index, **launch_counts()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
