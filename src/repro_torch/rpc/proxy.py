"""RemoteWorkerProxy — a fabric worker whose compute lives across TCP (port
of ``repro.rpc.proxy``).

The proxy satisfies the exact surface ``ServeFabric`` + its watchdog consume
from :class:`~repro_torch.serve.fabric.FabricWorker`
(``start/alive/join/kill``, ``beat_age``, ``take_inflight``, ``backlog``,
``.scheduler``, ``.batcher``, ``.copy_meter``, ``.index``/``.group``), so
the fabric's admission control,
weighted-fair scheduling, routing, STALLED/DEAD watchdog semantics and
failover re-routing all work UNCHANGED over the wire:

* admission + fair order stay coordinator-side: ``fabric.submit`` offers
  into the proxy's real :class:`FairScheduler`; a sender thread pops in
  weighted-fair order and ships REQUEST frames (at most
  ``ServeConfig.max_queue`` outstanding — backlog beyond that stays in the
  scheduler where per-tenant quotas keep meaning something);
* shipped-but-unanswered requests live in ``_outstanding`` — the remote
  analogue of the worker's in-flight batch.  When the channel dies the
  sender thread exits, the watchdog sees ``alive() == False`` (the DEAD
  path), and ``take_inflight()`` hands the orphans back for re-routing on
  survivors — capped by ``FabricConfig.max_retries`` then ``WorkerDown``,
  exactly the in-proc chaos contract;
* ``beat_age`` merges local heartbeat silence with the endpoint's own
  reported worker beat age, so the STALLED path fires both for a dead
  network and for a wedged remote compute loop;
* ``kill()`` severs the connection (a network partition in one call — the
  chaos tests' remote analogue of the in-proc kill hook).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis import guarded_by
from repro_torch.featurestore.meter import TrafficMeter
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.metrics import BatchRecord
from repro_torch.serve.server import ServeResult
from repro_torch.serve.tenancy import FairScheduler

from . import wire
from .channel import Channel, RpcError


def parse_endpoint(addr: str) -> Tuple[str, int]:
    """``"host:port"`` (or bare ``":port"`` / ``"port"``) -> (host, port)."""
    if ":" in addr:
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)
    return "127.0.0.1", int(addr)


@guarded_by("_plock", "_outstanding")
class RemoteWorkerProxy:
    """Drop-in fabric worker backed by one :class:`Channel` to an endpoint.

    ``_outstanding`` (req id -> (pending, t_sent)) is written by the sender
    thread and the channel's receiver thread, reclaimed by the watchdog —
    all under ``_plock``.
    """

    def __init__(self, fabric, index: int, address: str):
        self.fabric = fabric
        self.index = index
        self.group = index
        self.address = address
        cfg, serve_cfg = fabric.cfg, fabric.serve_cfg
        self.scheduler = FairScheduler(
            cfg.tenants, default_weight=cfg.default_weight,
            default_quota=cfg.default_quota)
        # interface parity only (capacity check, stop()-time drain): the
        # remote batcher does the real coalescing
        self.batcher = MicroBatcher(
            serve_cfg.buckets, max_wait_s=serve_cfg.max_wait_ms * 1e-3,
            max_queue=max(serve_cfg.max_queue, 2 * len(serve_cfg.buckets)))
        # this proxy's wire traffic (tx under the channel send lock, rx on
        # its receiver thread) — aggregated by ServeFabric.snapshot()
        self.copy_meter = TrafficMeter()
        self.channel = Channel(
            name=f"worker{index}", meter=self.copy_meter,
            on_frame=self._on_frame,
            seed=fabric.engine.cfg.seed + 0xC4A + index)
        self._plock = threading.Lock()
        self._outstanding: Dict[int, tuple] = {}
        self._req_seq = 0               # sender thread only
        self._inflight_cap = max(serve_cfg.max_queue, 1)
        self._sender: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # worker interface (what fabric/watchdog/stop call)
    # ------------------------------------------------------------------
    def start(self) -> None:
        assert self._sender is None, "proxy already started"
        cfg = self.fabric.cfg
        host, port = parse_endpoint(self.address)
        self.channel.connect(
            host, port, timeout_s=cfg.connect_timeout_ms * 1e-3,
            retries=cfg.connect_retries,
            backoff_s=cfg.connect_backoff_ms * 1e-3)
        _kind, meta, arrays = self.channel.call(
            wire.HELLO, {"index": self.index},
            timeout=max(cfg.connect_timeout_ms * 1e-3, 30.0))
        self.fabric._adopt_remote_table(self.index, wire.unpack_table(
            meta, arrays))
        self._sender = threading.Thread(
            target=self._send_loop, daemon=True,
            name=f"gns-rpc-send-{self.index}")
        self._sender.start()

    def alive(self) -> bool:
        t = self._sender
        return t is not None and t.is_alive()

    def join(self, timeout: float) -> None:
        t = self._sender
        if t is not None:
            t.join(timeout)

    def kill(self) -> None:
        """Chaos hook: sever the connection (a one-call network partition).
        The endpoint keeps running; this coordinator's watchdog reclaims."""
        self.channel.close()

    def beat_age(self, now: float) -> float:
        return self.channel.beat_age(now)

    def take_inflight(self) -> List:
        """Watchdog reclaim of shipped-but-unanswered requests — only
        meaningful once the sender thread is dead (channel down: no RESULT
        can race the reclaim)."""
        with self._plock:
            out = [p for p, _t in self._outstanding.values()]
            self._outstanding = {}
        return out

    def backlog(self) -> int:
        return self.scheduler.qsize() + self.inflight_count() \
            + self.batcher.qsize()

    def inflight_count(self) -> int:
        with self._plock:
            return len(self._outstanding)

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------
    def request_refresh(self, version: Optional[int] = None) -> None:
        try:
            self.channel.send(wire.REFRESH, {"version": version})
        except RpcError:
            pass                        # dead channel: watchdog's business

    def fetch_remote_stats(self, timeout: float = 5.0) -> dict:
        _kind, meta, _arrays = self.channel.call(
            wire.STATS_REQ, timeout=timeout)
        return meta

    # ------------------------------------------------------------------
    # sender thread: scheduler -> wire, weighted-fair, bounded in-flight
    # ------------------------------------------------------------------
    def _send_loop(self) -> None:
        fab = self.fabric
        try:
            while True:
                if not self.channel.rpc_connected:
                    return
                if fab.stopping and (not fab.drain_on_stop
                                     or self._drained()):
                    return
                if self.inflight_count() >= self._inflight_cap:
                    time.sleep(0.001)
                    continue
                nxt = self.scheduler.pop()
                if nxt is None:
                    self.scheduler.work_ev.wait(timeout=0.02)
                    continue
                tenant, p = nxt
                now = time.monotonic()
                self._req_seq += 1
                rid = self._req_seq
                with self._plock:
                    self._outstanding[rid] = (p, now)
                meta = {"req": rid, "tenant": tenant,
                        "attempts": p.attempts,
                        "deadline_ms": (max((p.deadline - now) * 1e3, 0.0)
                                        if p.deadline is not None else None)}
                try:
                    self.channel.send(wire.REQUEST, meta,
                                      {"ids": p.node_ids})
                except RpcError:
                    # p stays in _outstanding: the watchdog's DEAD path
                    # reclaims it via take_inflight()
                    return
        finally:
            if fab.stopping:
                # drained (or drain disabled): a clean goodbye — the
                # endpoint goes back to accept() with a warm replica
                self.channel.close()

    def _drained(self) -> bool:
        return (self.scheduler.qsize() == 0 and self.inflight_count() == 0
                and self.batcher.qsize() == 0)

    # ------------------------------------------------------------------
    # receiver callback (channel recv thread)
    # ------------------------------------------------------------------
    def _on_frame(self, kind: int, meta: dict, arrays: dict) -> None:
        fab = self.fabric
        if kind == wire.RESULT:
            rid = int(meta["req"])
            with self._plock:
                entry = self._outstanding.pop(rid, None)
            if entry is None:
                return              # already reclaimed/re-routed elsewhere
            p, t_sent = entry
            now = time.monotonic()
            status = meta.get("status", "error")
            total_s = now - p.t_submit
            if status == "ok":
                remote_total = float(meta.get("remote_total_s", 0.0))
                # wire + (de)serialization time: round trip minus the span
                # the endpoint actually held the request
                rpc_s = max((now - t_sent) - remote_total, 0.0)
                qw = (t_sent - p.t_submit) \
                    + float(meta.get("queue_wait_s", 0.0))
                compute_s = float(meta.get("compute_s", 0.0))
                late = p.deadline is not None and now > p.deadline
                res = ServeResult(
                    logits=np.array(arrays["logits"], copy=True),
                    status="ok", queue_wait_s=qw, compute_s=compute_s,
                    total_s=total_s, bucket=int(meta.get("bucket", 0)),
                    cache_version=int(meta.get("cache_version", -1)))
                fab.meter.observe_request(qw, compute_s, total_s,
                                          tenant=p.tenant, late=late,
                                          rpc_s=rpc_s)
                p.future._complete(res)
            elif status == "expired":
                fab.meter.observe_expired(total_s, tenant=p.tenant)
                p.future._complete(ServeResult(
                    logits=None, status="expired", queue_wait_s=total_s,
                    total_s=total_s))
            else:
                fab.meter.observe_error(1)
                p.future._fail(RpcError(meta.get("error", "remote error")))
        elif kind == wire.BATCH:
            fab.meter.observe_batch(
                BatchRecord(
                    bucket=int(meta["bucket"]),
                    n_requests=int(meta["n_requests"]),
                    n_ids=int(meta["n_ids"]),
                    compute_s=float(meta["compute_s"]),
                    cache_version=int(meta["cache_version"]),
                    hit_fraction=float(meta["hit_fraction"])),
                worker=self.index)
        elif kind == wire.SWAPPED:
            fab._on_remote_swap(self.index,
                                wire.unpack_table(meta, arrays))
        elif kind == wire.ERROR:
            fab._note_fabric_error(RpcError(
                meta.get("error", f"endpoint {self.index} reported a "
                                  "fatal error")))
