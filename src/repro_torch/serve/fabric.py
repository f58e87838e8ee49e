"""ServeFabric — the multi-tenant, multi-worker serving fleet (port of
``repro.serve.fabric``).

:class:`~repro_torch.serve.server.GNSServer` serves off the live cache
generation with one worker; the fabric scales that to N workers without
giving up any of its invariants:

* **N workers, one cache.**  Each :class:`FabricWorker` owns a DP group
  (``group = worker index``), a
  :class:`~repro_torch.serve.tenancy.FairScheduler` and a
  :class:`~repro_torch.serve.batcher.MicroBatcher`; all of them sample
  against the SAME :class:`~repro_torch.featurestore.FeatureStore`
  generation.  Sampling windows (store.serving scope + ``infer_prepare``)
  are serialized under one fabric-level sample lock — the store's "one
  accounting mode at a time" contract and the shared per-bucket samplers
  both require it — while the forwards (``infer_compute``: K1 and K2 on a
  CUDA device, launched on the default stream from each worker thread) run
  concurrently.
* **Placement-aware routing.**  ``submit`` routes each request through
  :class:`~repro_torch.serve.router.Router` to the worker whose home shard
  owns the most of its ids (table re-adopted at every generation swap); the
  request's ids then land on that worker's DP-group histogram, so the next
  placement solve pulls its hot rows local — routing and placement converge
  on each other.
* **Per-tenant isolation.**  Admission happens at the chosen worker's
  per-tenant bounded queue: a flooding tenant fills its OWN quota and eats
  its own :class:`~repro_torch.serve.server.QueueFull` while other tenants'
  admissions stay untouched.
* **Failover.**  A watchdog thread detects stalled workers (stale
  heartbeat) and dead workers (thread gone): either way the worker leaves
  the routing rotation and its queued requests are re-routed to healthy
  workers (``max_retries`` re-routes per request, then the future fails
  with :class:`WorkerDown`); a dead worker's in-flight batch is reclaimed
  and re-routed too.  A stalled worker that wakes up re-enters the
  rotation on its next heartbeat.
* **Generation maintenance is centralized.**  Only the watchdog publishes
  completed refreshes (``swap_if_ready``), kicks serving-driven refreshes
  and drains staged streaming deltas into an async build — workers never
  touch the swap path, so batches keep pinning their generation exactly as
  in the single server (bitwise-identical results across a swap).

On a CUDA engine :meth:`ServeFabric.start` builds the kernels before any
worker starts (a build failure raises from ``start()``), so no worker's
first batch stalls the others behind the build.  Under
``FabricConfig(transport="tcp")`` each worker is a
:class:`~repro_torch.rpc.RemoteWorkerProxy` to a
:class:`~repro_torch.rpc.WorkerEndpoint` process that holds its own engine
replica and cache generations: the coordinator then computes nothing (no
generation 0, no kernel build) and only drives the refresh cadence.  It
is one process, as in the reference, whatever the config's mesh: its
engine comes from :meth:`~repro_torch.gns.GNSEngine.coordinator` (the
config without the mesh, its cache in the mesh's shards, which is all the
router reads), and each endpoint of a mesh config is the world of ranks
(:mod:`repro_torch.rpc.endpoint`).  A tcp fabric over an engine on a mesh
is refused.

**On a mesh** (an engine over a :class:`~repro_torch.launch.mesh.HostMesh`
of ``torch.distributed`` ranks) every rank builds, starts and stops the
fabric, in the same order.  The leader (global rank 0) runs ``submit``,
tenancy, the router, every worker's scheduler and batcher, and the
watchdog's health, failover and refresh decisions; ``submit`` elsewhere
raises :class:`~repro_torch.launch.mesh.NotLeader`.  Worker ``w`` runs
on every rank: its leader thread sends each batch it samples (ids,
bucket, pinned generation, the kill flag) over a gloo channel of its own,
and worker ``w`` on every other rank samples it with the same rng and
group stamp and runs the same forward, whose sharded K1 sums over process
groups of worker ``w``'s own (each thread that issues collectives has its
own groups, made here in one order on every rank).  The watchdog alone drives
the store's agreements: the leader's tells the others' when, with its
decisions (stop flag, refresh due).  A swap is ordered against the
workers' sampling: the leader publishes under its sample lock and sends
how many batches it had sampled; every other rank publishes once it has
sampled those same batches, and a batch pinned to a generation a rank has
not published yet waits for it — so every rank samples every batch
against the same generation.  A killed worker dies on every rank after
sampling its batch, and the failover stays on the leader.

Lock order (enforced by the runtime sanitizer of
:mod:`repro_torch.analysis`): every lock in the fabric is leaf-held — no
code path acquires a second fabric lock while holding one, and
meter/scheduler/router internals take only their own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.analysis import TrackedLock, guarded_by, sanitizer_enabled
from repro_torch.featurestore.meter import TrafficMeter
from repro_torch.launch.mesh import (Channel, MeshDesync, NotLeader,
                                     new_host_group)
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.metrics import BatchRecord, ServeMeter
from repro_torch.serve.router import Router
from repro_torch.serve.server import (QueueFull, ServeFuture, ServeResult,
                                ServerClosed)
from repro_torch.serve.tenancy import FairScheduler

DEFAULT_TENANT = "default"
_FOLLOW_BOUND_S = 300.0     # a follower's longest wait for the leader's
                            # next step, where the mesh sets no timeout


class WorkerDown(RuntimeError):
    """No healthy worker could take the request (after retries)."""


class WorkerKilled(RuntimeError):
    """Chaos-test injection: the worker thread aborts mid-batch."""


@dataclasses.dataclass
class _FabPending:
    """A routed request (fabric-internal; batcher-compatible shape)."""
    node_ids: np.ndarray
    future: ServeFuture
    t_submit: float                   # monotonic
    deadline: Optional[float]         # absolute monotonic, None = unbounded
    tenant: str = DEFAULT_TENANT
    attempts: int = 0                 # failover re-routes so far


@guarded_by("_wlock", "_inflight", writes_only=("last_beat",))
class FabricWorker:
    """One serving worker: scheduler -> micro-batcher -> forward.

    The worker thread is the only writer of ``_inflight`` while alive; the
    watchdog reclaims it (under ``_wlock``) only after the thread died.
    ``last_beat`` is written once per loop iteration and read lock-free by
    the watchdog (writes_only snapshot contract).
    """

    def __init__(self, fabric: "ServeFabric", index: int):
        self.fabric = fabric
        self.index = index
        self.group = index                  # DP group / histogram row;
                                            # home shard = group % n_shards
        cfg, serve_cfg = fabric.cfg, fabric.serve_cfg
        self.scheduler = FairScheduler(
            cfg.tenants, default_weight=cfg.default_weight,
            default_quota=cfg.default_quota)
        # the batcher's own queue is kept shallow (~ one batch ahead):
        # backlog lives in the scheduler where quotas + fair order apply
        self.batcher = MicroBatcher(
            serve_cfg.buckets, max_wait_s=serve_cfg.max_wait_ms * 1e-3,
            max_queue=max(serve_cfg.max_queue, 2 * len(serve_cfg.buckets)))
        self.copy_meter = TrafficMeter()    # single-writer host->device
                                            # booking for THIS worker's
                                            # compute calls
        self._rng = np.random.default_rng(
            fabric.engine.cfg.seed + 0xFAB0 + index)
        self._wlock = threading.Lock()
        self._inflight: List[_FabPending] = []
        self.last_beat = time.monotonic()
        self._fed_ids = 0                   # ids sitting in the batcher
                                            # (worker-thread only)
        self.stall_s = 0.0                  # chaos hook: sleep mid-batch
        self._die = False                   # chaos hook: abort mid-batch
        self._thread: Optional[threading.Thread] = None
        # on a mesh: this worker's own process groups and command channel
        self.mesh = None
        self.channel: Optional[Channel] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        assert self._thread is None, "worker already started"
        self._thread = threading.Thread(
            target=self._run if self.fabric.leader else self._follow,
            daemon=True, name=f"gns-fabric-{self.index}")
        self._thread.start()

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def join(self, timeout: float) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def kill(self) -> None:
        """Chaos hook: the next batch aborts the worker thread mid-flight
        (on a mesh the leader's call kills the worker on every rank)."""
        self._die = True

    def beat_age(self, now: float) -> float:
        return now - self.last_beat       # lock-free snapshot (writes_only)

    def take_inflight(self) -> List[_FabPending]:
        """Watchdog reclaim — only meaningful once the thread is dead."""
        with self._wlock:
            out, self._inflight = self._inflight, []
        return out

    def backlog(self) -> int:
        return self.scheduler.qsize() + self.batcher.qsize()

    # ------------------------------------------------------------------
    # worker thread
    # ------------------------------------------------------------------
    def _beat(self) -> None:
        with self._wlock:
            self.last_beat = time.monotonic()

    def _pump(self) -> None:
        """Move requests scheduler -> batcher in weighted-fair order, at
        most ~one batch's worth ahead (backlog must stay in the scheduler
        so quotas keep meaning something)."""
        while self._fed_ids < self.batcher.capacity:
            nxt = self.scheduler.pop()
            if nxt is None:
                return
            tenant, p = nxt
            if not self.batcher.offer(p):
                self.scheduler.push_front(tenant, p)   # keep FIFO
                return
            self._fed_ids += len(p.node_ids)

    def _run(self) -> None:
        fab = self.fabric
        killed = False
        try:
            while True:
                self._beat()
                self._pump()
                batch = self.batcher.next_batch(timeout=0.002)
                if batch is None:
                    if fab.stopping and (not fab.drain_on_stop
                                         or self.backlog() == 0):
                        return
                    if self.channel is not None:
                        self.channel.send(Channel.HEARTBEAT)
                    self.scheduler.work_ev.wait(timeout=0.02)
                    continue
                self._fed_ids -= sum(len(p.node_ids) for p in batch)
                t_start = time.monotonic()
                live, expired = [], []
                for p in batch:
                    (expired if p.deadline is not None
                     and p.deadline < t_start else live).append(p)
                for p in expired:
                    fab.meter.observe_expired(t_start - p.t_submit,
                                              tenant=p.tenant)
                    p.future._complete(ServeResult(
                        logits=None, status="expired",
                        queue_wait_s=t_start - p.t_submit,
                        total_s=t_start - p.t_submit))
                if not live:
                    continue
                with self._wlock:
                    self._inflight = list(live)
                try:
                    self._serve_batch(live, t_start)
                except WorkerKilled:
                    killed = True  # chaos: die with the batch in flight —
                    return         # the watchdog reclaims _inflight and
                                   # re-routes
                except BaseException as e:
                    fab.meter.observe_error(len(live))
                    for p in live:
                        p.future._fail(e)
                with self._wlock:
                    self._inflight = []
                if fab.stopping and (not fab.drain_on_stop
                                     or self.backlog() == 0):
                    return
        finally:
            if self.channel is not None and not killed:
                self.channel.send(Channel.STOP)

    def _serve_batch(self, live: Sequence[_FabPending],
                     t_start: float) -> None:
        fab = self.fabric
        eng = fab.engine
        ids = np.concatenate([p.node_ids for p in live])
        bucket = self.batcher.bucket_for(len(ids))
        t0 = time.perf_counter()
        mb = fab._prepare(self, ids, bucket)
        if self.stall_s:
            time.sleep(self.stall_s)      # chaos hook: in-flight stall
        die = self._die
        if self.channel is not None:      # the batch, on every rank
            self.channel.send(Channel.BATCH, (bucket, mb.cache_version,
                                              die, len(live)), ids)
        if die:
            raise WorkerKilled(f"worker {self.index} killed (chaos hook)")
        logits = eng.infer_compute(mb, meter=self.copy_meter, mesh=self.mesh)
        compute_s = time.perf_counter() - t0
        t_done = time.monotonic()
        version = mb.cache_version
        fab.meter.observe_batch(BatchRecord(
            bucket=bucket, n_requests=len(live), n_ids=len(ids),
            compute_s=compute_s, cache_version=version,
            hit_fraction=mb.num_cached / max(mb.num_input, 1)),
            worker=self.index)
        lo = 0
        for p in live:
            n = len(p.node_ids)
            # copy, don't view (as GNSServer._serve_batch)
            res = ServeResult(
                logits=logits[lo:lo + n].copy(), status="ok",
                queue_wait_s=t_start - p.t_submit, compute_s=compute_s,
                total_s=t_done - p.t_submit, bucket=bucket,
                cache_version=version)
            lo += n
            fab.meter.observe_request(
                res.queue_wait_s, res.compute_s, res.total_s,
                tenant=p.tenant,
                late=p.deadline is not None and t_done > p.deadline)
            p.future._complete(res)

    def _follow(self) -> None:
        """Worker ``index`` on a rank other than the leader: sample and run
        the leader's batches in its order, against the generation each
        pins.  A batch this rank cannot run as the leader did ends the
        loop, and the fabric's ``stop()`` raises it."""
        fab = self.fabric
        eng = fab.engine
        try:
            while True:
                kind, fields, ids = self.channel.recv()
                if kind == Channel.STOP:
                    return
                if kind != Channel.BATCH:
                    continue
                bucket, version, die, n_requests = fields[:4]
                fab._await_version(version)
                t0 = time.perf_counter()
                mb = fab._prepare(self, ids, bucket)
                if mb.cache_version != version:
                    raise MeshDesync(
                        f"worker {self.index} on rank {self.mesh.rank} "
                        f"sampled generation {mb.cache_version}, the "
                        f"leader {version}")
                if die:
                    return            # killed on the leader, after sampling
                try:
                    eng.infer_compute(mb, meter=self.copy_meter,
                                      mesh=self.mesh)
                except Exception:     # the leader fails the same batch
                    fab.meter.observe_error(n_requests)
                    continue
                fab.meter.observe_batch(BatchRecord(
                    bucket=bucket, n_requests=n_requests, n_ids=len(ids),
                    compute_s=time.perf_counter() - t0,
                    cache_version=version,
                    hit_fraction=mb.num_cached / max(mb.num_input, 1)),
                    worker=self.index)
        except Exception as e:        # raised by this rank's stop()
            fab._follow_errors.append(e)


@guarded_by("_flock", "_healthy", writes_only=("_fab_accepting",
                                               "fabric_error"))
class ServeFabric:
    """The worker fleet + router + watchdog over one GNSEngine.

    Usage::

        fabric = engine.serve_fabric()        # FabricConfig via EngineConfig
        with fabric:
            fut = fabric.submit(ids, tenant="mobile")
            res = fut.result(timeout=10)
        print(fabric.meter.snapshot())        # incl. per-tenant + routing
    """

    def __init__(self, engine, cfg=None, serve_cfg=None):
        if cfg is None:
            cfg = engine.cfg.serve_config().fabric
        if cfg is None:
            from repro_torch.gns.config import FabricConfig
            cfg = FabricConfig()
        assert cfg.workers >= 1, cfg
        self.engine = engine
        self.cfg = cfg
        self.serve_cfg = (serve_cfg if serve_cfg is not None
                          else engine.cfg.serve_config())
        self.meter = ServeMeter(latency_window=self.serve_cfg.latency_window)
        n_shards = engine.store.n_shards if engine.store is not None else 1
        self.router = Router(range(cfg.workers), n_shards,
                             mode=("locality" if cfg.routing == "locality"
                                   else "spread"))
        # serializes every worker's sampling window: the store's
        # serving-scope/dp_group flips and the shared per-bucket samplers
        # are store-global state.  Wrapped for the sanitizer's lock-order
        # graph even though no guarded attrs live under it.
        lk = threading.Lock()
        self._sample_lock = (TrackedLock(lk, "ServeFabric._sample_lock")
                             if sanitizer_enabled() else lk)
        self._flock = threading.Lock()
        self._healthy = frozenset(range(cfg.workers))
        self._fab_accepting = False
        self.fabric_error: Optional[BaseException] = None
                                    # last failed serving-driven build
                                    # (serving continues on the live gen)
        self.stopping = False       # worker exit flag (monotonic: set once
                                    # by stop(), plain-read by workers)
        self.drain_on_stop = True
        self._stop = threading.Event()
        self._refresh_rng = np.random.default_rng(engine.cfg.seed + 0x5E12)
        self._last_refresh_batches = 0
        mesh = engine.mesh
        self.leader = mesh is None or mesh.leader
        if cfg.transport == "tcp":
            # cross-host fleet: each worker is a proxy over a TCP channel
            # to a WorkerEndpoint process holding its own cache replica;
            # the coordinator is one process (module docstring)
            from repro_torch.rpc import RemoteWorkerProxy
            if mesh is not None:
                raise ValueError(
                    "transport='tcp' runs its coordinator as one process, "
                    "not on a mesh of ranks: build its engine with "
                    "GNSEngine.coordinator(cfg)")
            endpoints = tuple(cfg.endpoints)
            if len(endpoints) != cfg.workers:
                raise ValueError(
                    f"transport='tcp' needs one endpoint per worker: "
                    f"{len(endpoints)} endpoints for {cfg.workers} workers")
            self.workers = [RemoteWorkerProxy(self, i, endpoints[i])
                            for i in range(cfg.workers)]
        else:
            if cfg.transport != "inproc":
                raise ValueError(f"unknown transport {cfg.transport!r}")
            self.workers = [FabricWorker(self, i) for i in range(cfg.workers)]
        self._watchdog: Optional[threading.Thread] = None
        # on a mesh: every thread that issues collectives gets groups of
        # its own (made in one order on every rank); the sampling windows
        # are counted, so a follower publishes a swap after the same ones
        self._watch_channel: Optional[Channel] = None
        self._windows = 0                 # sampling windows, under the
                                          # sample lock
        self._follow_cv = threading.Condition()
        self._follow_errors: list = []
        self._bound_s = _FOLLOW_BOUND_S
        if mesh is not None:
            if mesh.timeout is not None:
                self._bound_s = mesh.timeout.total_seconds()
            width = self.workers[0].batcher.capacity
            for w in self.workers:
                w.mesh = mesh.fork()
                w.channel = Channel(w.mesh.host_group, width)
            self._watch_channel = Channel(new_host_group(mesh.timeout), 0)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "ServeFabric":
        assert self._watchdog is None, "fabric already started"
        if self.cfg.transport == "tcp":
            # generation 0 lives on the endpoints (same config + same seeded
            # rng streams -> bitwise the generation the inproc fabric would
            # build); the placement leader's HELLO_ACK ships the routing
            # table, adopted via _adopt_remote_table during w.start()
            for w in self.workers:
                w.start()
        else:
            if self.engine.device.type == "cuda":
                # build the kernels now, not under the first worker's first
                # batch (the build holds the loader's lock for tens of
                # seconds, past any stall timeout); a failed build raises
                from repro_torch.kernels._ext import load_kernels
                load_kernels()
            # cold-start the cache before any worker runs, and give the
            # router its first table (generation 0's layout)
            self.engine.ensure_cache(self._refresh_rng)
            if self.engine.store is not None and self.leader:
                self.router.adopt(self.engine.store.routing_table())
            for w in self.workers:
                w.start()
        self._stop.clear()
        self._watchdog = threading.Thread(
            target=self._watch if self.leader else self._follow_watch,
            daemon=True, name="gns-fabric-watchdog")
        self._watchdog.start()
        with self._flock:
            self._fab_accepting = self.leader
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting, serve out queues (``drain=True``), join, cancel
        leftovers (never concurrently with a live worker).

        On a mesh the leader's ``stop`` ends every rank's threads; another
        rank's waits for that, then raises what ended a thread of its own
        otherwise."""
        if not self.leader:
            wd = self._watchdog
            while not self._follow_errors and (
                    (wd is not None and wd.is_alive())
                    or any(w.alive() for w in self.workers)):
                if wd is not None:
                    wd.join(0.05)
                for w in self.workers:
                    w.join(0.05)
            self._watchdog = None
            if self._follow_errors:       # at once: the leader is waiting
                raise self._follow_errors[0]   # on this rank
            return
        with self._flock:
            self._fab_accepting = False
        self.drain_on_stop = drain
        self.stopping = True
        self._stop.set()
        wd = self._watchdog
        if wd is not None:
            wd.join(timeout)
        self._watchdog = None
        deadline = time.monotonic() + timeout
        for w in self.workers:
            w.join(max(deadline - time.monotonic(), 0.1))
        for w in self.workers:
            if w.alive():
                continue      # stalled past timeout: leave its queue alone
            for _tenant, p in w.scheduler.drain():
                p.future._fail(ServerClosed("fabric stopped before serving"))
            for p in w.batcher.drain():
                p.future._fail(ServerClosed("fabric stopped before serving"))
            for p in w.take_inflight():
                p.future._fail(ServerClosed("fabric stopped before serving"))

    def __enter__(self) -> "ServeFabric":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def healthy(self) -> List[int]:
        with self._flock:
            return sorted(self._healthy)

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, node_ids: np.ndarray, tenant: str = DEFAULT_TENANT,
               deadline_ms: Optional[float] = None,
               worker: Optional[int] = None) -> ServeFuture:
        """Route + enqueue one request for ``tenant``.

        Raises :class:`QueueFull` when the tenant's queue on the chosen
        worker is at quota (that tenant's backpressure — nobody else's),
        :class:`WorkerDown` when no healthy worker exists,
        :class:`ServerClosed` outside start()/stop().  ``worker`` pins the
        request to one worker, bypassing routing AND health (test/ops
        escape hatch).  On a mesh only the leader takes requests
        (:class:`NotLeader` elsewhere).
        """
        if not self.leader:
            raise NotLeader("submit on a mesh goes to the leader (global "
                            "rank 0); the other ranks follow its batches")
        if not self._fab_accepting:
            raise ServerClosed("fabric is not accepting requests")
        ids = np.asarray(node_ids, dtype=np.int64).ravel()
        if not len(ids):
            raise ValueError("empty request")
        capacity = self.workers[0].batcher.capacity
        if len(ids) > capacity:
            raise ValueError(
                f"request of {len(ids)} ids exceeds the largest bucket "
                f"{capacity} — chunk it client-side")
        if deadline_ms is None:
            deadline_ms = self.serve_cfg.default_deadline_ms
        now = time.monotonic()
        p = _FabPending(
            node_ids=ids, future=ServeFuture(), t_submit=now,
            deadline=now + deadline_ms * 1e-3 if deadline_ms is not None
            else None, tenant=tenant)
        if worker is not None:
            target = worker
            self.meter.observe_route(0, 0, fallback=True)
        else:
            with self._flock:
                healthy = sorted(self._healthy)
            if not healthy:
                raise WorkerDown("no healthy workers")
            d = self.router.route(ids, healthy)
            target = d.worker
            self.meter.observe_route(d.known, d.local, fallback=d.fallback)
        self.meter.observe_submit(tenant)
        if not self.workers[target].scheduler.offer(tenant, p):
            self.meter.observe_reject(tenant)
            raise QueueFull(
                f"tenant {tenant!r} queue at quota on worker {target}")
        if not self._fab_accepting:
            # stop() raced the enqueue; its cancellation sweep may already
            # have run — never hand out a future nobody will complete
            p.future._fail(ServerClosed("fabric stopped while enqueueing"))
            raise ServerClosed("fabric stopped while the request enqueued")
        return p.future

    def infer(self, node_ids: np.ndarray, tenant: str = DEFAULT_TENANT,
              timeout: Optional[float] = 60.0) -> np.ndarray:
        """Blocking convenience: submit + wait; returns [n_ids, classes]."""
        res = self.submit(node_ids, tenant=tenant).result(timeout)
        if res.status != "ok":
            raise RuntimeError(f"request ended with status={res.status!r}")
        return res.logits

    # ------------------------------------------------------------------
    # sampling window (shared-store critical section)
    # ------------------------------------------------------------------
    def _prepare(self, worker: FabricWorker, ids: np.ndarray, bucket: int):
        """One serialized sampling window: route tier accounting to the
        serve meter, stamp the worker's DP group on the store (per-group
        histograms = the routing table's future), sample + assemble."""
        eng = self.engine
        with self._sample_lock:
            if eng.store is not None:
                eng.store.dp_group = worker.group
                with eng.store.serving(self.meter.traffic):
                    mb = eng.infer_prepare(ids, bucket=bucket,
                                           rng=worker._rng)
            else:
                mb = eng.infer_prepare(ids, bucket=bucket, rng=worker._rng)
            self._windows += 1
        if not self.leader:
            with self._follow_cv:
                self._follow_cv.notify_all()
        return mb

    # ------------------------------------------------------------------
    # on a mesh: the order of swaps and sampling on every rank
    # ------------------------------------------------------------------
    def _wait(self, pred, what: str) -> None:
        with self._follow_cv:
            if not self._follow_cv.wait_for(pred, timeout=self._bound_s):
                raise MeshDesync(f"waited {self._bound_s} s for {what}")

    def _await_version(self, version: int) -> None:
        """A follower's batch pinned to ``version`` waits until this rank
        has published it."""
        store = self.engine.store
        if store is None:
            return
        self._wait(lambda: store.version >= version,
                   f"generation {version}")
        if store.version != version:
            raise MeshDesync(f"the leader's batch pins generation "
                             f"{version}; this rank holds {store.version}")

    @contextlib.contextmanager
    def _swap_gate(self):
        """Around a swap's publish (``swap_if_ready(gate=)``): the leader
        publishes under its sample lock and sends its count of sampling
        windows; another rank publishes once it has sampled as many."""
        if self.leader:
            with self._sample_lock:
                yield
                n = self._windows
            self._watch_channel.send(Channel.SWAP, (n,))
            return
        kind, (n, *_), _ = self._watch_channel.recv()
        if kind != Channel.SWAP:
            raise MeshDesync(f"the leader's watchdog sent {kind}, not a "
                             f"swap")
        self._wait(lambda: self._windows >= n,
                   f"the {n} batches sampled before a swap")
        with self._sample_lock:
            yield
        with self._follow_cv:
            self._follow_cv.notify_all()

    # ------------------------------------------------------------------
    # watchdog: health, failover, generation maintenance
    # ------------------------------------------------------------------
    def _watch(self) -> None:
        try:
            self._watch_loop()
        finally:
            if self._watch_channel is not None:
                self._watch_channel.send(Channel.STOP)

    def _follow_watch(self) -> None:
        """The watchdog on a rank other than the leader: the store's
        agreements when the leader's watchdog says, with its decisions."""
        try:
            while True:
                kind, (stopping, due, *_), _ = self._watch_channel.recv()
                if kind == Channel.STOP:
                    return
                if kind == Channel.POLL:
                    self._maintain(self.engine.store, bool(stopping),
                                   bool(due))
        except Exception as e:        # raised by this rank's stop()
            self._follow_errors.append(e)

    def _watch_loop(self) -> None:
        interval = self.cfg.watch_interval_ms * 1e-3
        stall_s = self.cfg.stall_timeout_ms * 1e-3
        while not self._stop.wait(interval):
            self._poll_store()
            now = time.monotonic()
            for w in self.workers:
                dead = not w.alive()
                stalled = (not dead) and w.beat_age(now) > stall_s
                if dead or stalled:
                    with self._flock:
                        was_healthy = w.index in self._healthy
                        self._healthy = self._healthy - {w.index}
                        any_healthy = bool(self._healthy)
                    if was_healthy:
                        self.meter.observe_failover()
                    if stalled and not any_healthy:
                        # EVERY worker is stalled (e.g. a slow first
                        # batch on each): nowhere to re-route, and the
                        # workers are alive — leave the queue in place, it
                        # is served when they wake up.  Dead workers still
                        # drain below (fail fast is right when nothing can
                        # ever serve the requests).
                        continue
                    orphans = [p for _t, p in w.scheduler.drain()]
                    if dead:
                        # the thread is gone: its batcher + in-flight batch
                        # are safe to reclaim (no concurrent owner)
                        orphans.extend(w.batcher.drain())
                        orphans.extend(w.take_inflight())
                    for p in orphans:
                        self._reroute(p)
                else:
                    with self._flock:
                        if w.index not in self._healthy:
                            self._healthy = self._healthy | {w.index}

    def _reroute(self, p: _FabPending) -> None:
        """Failover: hand an orphaned request to a healthy worker."""
        if p.future.done():
            return
        now = time.monotonic()
        if p.deadline is not None and p.deadline < now:
            self.meter.observe_expired(now - p.t_submit, tenant=p.tenant)
            p.future._complete(ServeResult(
                logits=None, status="expired",
                queue_wait_s=now - p.t_submit, total_s=now - p.t_submit))
            return
        p.attempts += 1
        self.meter.observe_retry(p.tenant)
        if p.attempts > self.cfg.max_retries:
            p.future._fail(WorkerDown(
                f"request re-routed {p.attempts - 1} times without being "
                f"served"))
            return
        with self._flock:
            healthy = sorted(self._healthy)
        if not healthy:
            p.future._fail(WorkerDown("no healthy workers"))
            return
        d = self.router.route(p.node_ids, healthy)
        if not self.workers[d.worker].scheduler.offer(p.tenant, p):
            self.meter.observe_reject(p.tenant)
            p.future._fail(QueueFull(
                f"tenant {p.tenant!r} queue at quota on failover target "
                f"{d.worker}"))

    def _poll_store(self) -> None:
        """Swap point + refresh cadence + streaming-ingest drain (the
        single-server loop's tail, centralized so N workers never race the
        swap).  An error here (a failed build) is parked in
        ``fabric_error`` and counted; serving goes on off the live
        generation."""
        if self.cfg.transport == "tcp":
            # generations live on the endpoints: the coordinator only drives
            # the refresh CADENCE (broadcast REFRESH frames); each endpoint
            # swaps locally and ships its new table back in a SWAPPED frame
            # (_on_remote_swap adopts the placement leader's copy)
            every = self.serve_cfg.refresh_every
            if every is None or self._stop.is_set():
                return
            n = self.meter.batch_count()
            if n > 0 and n - self._last_refresh_batches >= every:
                self._last_refresh_batches = n
                for w in self.workers:
                    if w.alive():
                        w.request_refresh()
            return
        store = self.engine.store
        if store is None:
            return
        stopping = self._stop.is_set()
        every = self.serve_cfg.refresh_every
        n = self.meter.batch_count()
        due = (every is not None and not stopping and n > 0
               and n - self._last_refresh_batches >= every)
        if self._watch_channel is not None:     # the others' watchdogs
            self._watch_channel.send(Channel.POLL, (stopping, due))
        self._maintain(store, stopping, due, n)

    def _maintain(self, store, stopping: bool, due: bool,
                  n: Optional[int] = None) -> None:
        """The store's side of a watchdog poll, on every rank alike:
        ``stopping`` and ``due`` (the refresh cadence) are the leader's."""
        mesh = self.engine.mesh
        try:
            if store.swap_if_ready(
                    gate=self._swap_gate if mesh is not None else None):
                self.meter.observe_swap()
                if self.leader:
                    self.router.adopt(store.routing_table())
            if due and not store.refreshing:
                if n is not None:
                    self._last_refresh_batches = n
                store.begin_refresh(self._refresh_rng,
                                    version=store.version + 1)
            # streaming ingest: staged deltas past the merge threshold kick
            # an ASYNC build (which drains the buffer at its boundary) —
            # serving never pauses, the swap above publishes the merge
            if (not stopping and store.stream_merge_due()
                    and not store.refreshing):
                store.begin_refresh(self._refresh_rng,
                                    version=store.version + 1)
        except BaseException as e:
            with self._flock:         # publish to client threads
                self.fabric_error = e
            self.meter.observe_refresh_failure()

    # ------------------------------------------------------------------
    # tcp transport hooks (called by RemoteWorkerProxy threads)
    # ------------------------------------------------------------------
    def _placement_leader(self, candidate: int) -> int:
        """Which endpoint's routing table the Router follows: the
        lowest-index live worker (``candidate`` counts as live — it is the
        worker currently reporting).  Replicas under adaptive policies can
        drift apart; following ONE keeps routing coherent (divergence only
        costs locality on the others, never correctness)."""
        with self._flock:
            alive = {w.index for w in self.workers if w.alive()}
        alive.add(candidate)
        return min(alive)

    def _adopt_remote_table(self, index: int, table) -> None:
        """HELLO_ACK handshake: adopt the placement leader's table."""
        if table is not None and index == self._placement_leader(index):
            self.router.adopt(table)

    def _on_remote_swap(self, index: int, table) -> None:
        """SWAPPED frame: an endpoint published a new generation."""
        if index == self._placement_leader(index):
            self.meter.observe_swap()
            if table is not None:
                self.router.adopt(table)

    def _note_fabric_error(self, err: BaseException) -> None:
        with self._flock:
            self.fabric_error = err
        self.meter.observe_refresh_failure()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def rpc_traffic(self) -> dict:
        """Aggregate wire bytes over the workers' meters (0 in process: no
        frame crosses a wire)."""
        tx = sum(w.copy_meter.bytes_rpc_tx for w in self.workers)
        rx = sum(w.copy_meter.bytes_rpc_rx for w in self.workers)
        return {"bytes_rpc_tx": tx, "bytes_rpc_rx": rx}

    def pull_remote_stats(self, timeout: float = 5.0) -> dict:
        """tcp transport: pull each live endpoint's STATS (remote tenant
        ledgers + wire counters) into the serve meter's ``remote`` section.
        Returns the raw per-worker replies (``{}`` in process: there is no
        endpoint to ask)."""
        out = {}
        if self.cfg.transport != "tcp":
            return out
        from repro_torch.rpc import RpcError
        for w in self.workers:
            if not w.alive():
                continue
            try:
                stats = w.fetch_remote_stats(timeout=timeout)
            except (RpcError, TimeoutError):
                continue
            out[w.index] = stats
            self.meter.observe_remote_stats(w.index, stats)
        return out

    def snapshot(self) -> dict:
        """``meter.snapshot()`` plus the transport view: scheduler
        fair-share counters per worker and, over tcp, the aggregate wire
        traffic."""
        snap = self.meter.snapshot()
        snap["scheduler_counters"] = {
            w.index: w.scheduler.counters() for w in self.workers}
        if self.cfg.transport == "tcp":
            snap["rpc"] = self.rpc_traffic()
        return snap
