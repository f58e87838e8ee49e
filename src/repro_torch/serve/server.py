"""GNSServer — the persistent GNS serving loop (port of
``repro.serve.server``).

Turns ``GNSEngine.infer()`` from a one-shot call into a request loop:

* requests (node-id chunks, optional deadlines) enter a **bounded queue**
  (admission control: a full queue rejects, it never silently grows);
* a single worker thread pulls **dynamically micro-batched**, size-bucketed
  batches (:class:`~repro_torch.serve.batcher.MicroBatcher`) and runs them
  through the engine's forward — the CUDA kernels on a GPU — at one fixed
  set of shapes per bucket;
* every batch **rides the live cache generation safely**: the sampled
  minibatch pins the generation it was assembled against
  (``MiniBatch.cache_gen``), so an async refresh swapping underneath can
  never tear an in-flight request;
* serving lookups run inside ``FeatureStore.serving(meter.traffic)``:
  tier/time accounting lands on the serving-side meter while the adaptive
  policy's EMA keeps observing, so with ``ServeConfig.refresh_every`` set,
  periodic async refreshes re-draw the cache toward the *inference* hot set;
* per-request latency (queue wait vs compute) and the cache-hit trajectory
  are readable from :class:`~repro_torch.serve.metrics.ServeMeter`.

The worker polls ``swap_if_ready`` between batches and the bucket samplers
adopt monotonically — never while a batch is being assembled or computed.
The same seed and the same sequence of requests give the reference's
batches, array for array.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.analysis import guarded_by
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.metrics import BatchRecord, ServeMeter


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue refused the request."""


class ServerClosed(RuntimeError):
    """submit() after stop() (or before start())."""


@dataclasses.dataclass
class ServeResult:
    """One completed request."""
    logits: Optional[np.ndarray]    # [n_ids, classes] f32; None unless ok
    status: str                     # "ok" | "expired" | "error"
    queue_wait_s: float = 0.0       # submit -> dequeued into a batch
    compute_s: float = 0.0          # its batch's sample + forward + readback
    total_s: float = 0.0            # submit -> completion
    bucket: int = 0                 # padded batch size it rode (0 if none)
    cache_version: int = -1         # generation its batch was pinned to


@guarded_by("_lock", writes_only=("_result", "_err"))
class ServeFuture:
    """Completion handle for one submitted request.

    Completion is first-wins: a second ``_complete``/``_fail`` is ignored
    (a request is served OR failed, never re-resolved — defense in depth
    for shutdown edges).  ``_result``/``_err`` are written under ``_lock``;
    ``result()`` reads them lock-free, which is safe because ``_ev.set()``
    happens-after the write and ``_ev.wait()`` happens-before the read."""

    def __init__(self):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[ServeResult] = None
        self._err: Optional[BaseException] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._ev.wait(timeout):
            raise TimeoutError("request not completed within timeout")
        if self._err is not None:
            raise self._err
        return self._result

    # server-side completion
    def _complete(self, result: ServeResult) -> None:
        with self._lock:
            if self._ev.is_set():
                return
            self._result = result
            self._ev.set()

    def _fail(self, err: BaseException) -> None:
        with self._lock:
            if self._ev.is_set():
                return
            self._err = err
            self._ev.set()


@dataclasses.dataclass
class _Pending:
    """A queued request (internal)."""
    node_ids: np.ndarray
    future: ServeFuture
    t_submit: float                   # monotonic
    deadline: Optional[float]         # absolute monotonic, None = unbounded


@guarded_by("_state_lock", writes_only=("refresh_error", "_accepting"))
class GNSServer:
    """The persistent serving loop over one
    :class:`~repro_torch.gns.GNSEngine`.

    Usage::

        server = engine.serve()            # or GNSServer(engine, serve_cfg)
        with server:                       # start()/stop() pair
            fut = server.submit(node_ids)  # raises QueueFull when saturated
            res = fut.result(timeout=10)   # res.logits: [n_ids, classes]
        print(server.meter.snapshot())     # p50/p99, hit rate, rejects ...
    """

    def __init__(self, engine, cfg=None):
        if cfg is None:
            cfg = engine.cfg.serve
        self.engine = engine
        self.cfg = cfg
        self.meter = ServeMeter(latency_window=cfg.latency_window)
        self.batcher = MicroBatcher(cfg.buckets,
                                    max_wait_s=cfg.max_wait_ms * 1e-3,
                                    max_queue=cfg.max_queue)
        self._rng = np.random.default_rng(engine.cfg.seed + 0x5E12)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._drain = True
        self._state_lock = threading.Lock()
                              # guards WRITES of the worker->client flags
                              # (refresh_error, _accepting): clients read
                              # them lock-free as snapshots
        self._accepting = False
        self._last_version = -1
        self.refresh_error: Optional[BaseException] = None
                              # last failed serving-driven generation build
                              # (serving continues on the live generation)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "GNSServer":
        assert self._thread is None, "server already started"
        # cold-start the cache OUTSIDE the loop so the first request does
        # not pay the generation build
        self.engine.ensure_cache(self._rng)
        self._stop.clear()
        with self._state_lock:
            self._accepting = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gns-serve")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop accepting; by default serve out the queue, then join.

        ``drain=False`` makes the worker exit at the next batch boundary
        instead; queued requests are cancelled AFTER the join (never
        concurrently with the worker — a request must not be served and
        failed at the same time)."""
        with self._state_lock:
            self._accepting = False
        self._drain = drain
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # join timed out: the worker still owns the queue — leave
                # it alone (cancelling now could fail a request the worker
                # is serving); the caller may retry stop()
                return
        self._thread = None
        self._cancel_queued()         # whatever the worker left behind

    def __enter__(self) -> "GNSServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, node_ids: np.ndarray,
               deadline_ms: Optional[float] = None) -> ServeFuture:
        """Enqueue one inference request; returns its completion future.

        Raises :class:`QueueFull` when the bounded queue refuses it
        (backpressure — the caller sheds or retries), :class:`ServerClosed`
        after ``stop()``.  ``deadline_ms`` (default from the config) is
        measured from submission; a request still queued past it completes
        with ``status="expired"`` and never touches the device.
        """
        if not self._accepting:
            raise ServerClosed("server is not accepting requests")
        ids = np.asarray(node_ids, dtype=np.int64).ravel()
        if not len(ids):
            raise ValueError("empty request")
        if len(ids) > self.batcher.capacity:
            raise ValueError(
                f"request of {len(ids)} ids exceeds the largest bucket "
                f"{self.batcher.capacity} — chunk it client-side")
        if deadline_ms is None:
            deadline_ms = self.cfg.default_deadline_ms
        now = time.monotonic()
        pending = _Pending(
            node_ids=ids, future=ServeFuture(), t_submit=now,
            deadline=now + deadline_ms * 1e-3 if deadline_ms is not None
            else None)
        self.meter.observe_submit()         # locked: races across clients
        if not self.batcher.offer(pending):
            self.meter.observe_reject()
            raise QueueFull(
                f"request queue at capacity ({self.cfg.max_queue})")
        if not self._accepting:
            # stop() raced our enqueue and its cancellation sweep may have
            # already run — never hand out a future nobody will complete
            if not self.running:
                self._cancel_queued()
            raise ServerClosed("server stopped while the request enqueued")
        return pending.future

    def infer(self, node_ids: np.ndarray,
              timeout: Optional[float] = 60.0) -> np.ndarray:
        """Blocking convenience: submit + wait; returns [n_ids, classes]."""
        res = self.submit(node_ids).result(timeout)
        if res.status != "ok":
            raise RuntimeError(f"request ended with status={res.status!r}")
        return res.logits

    # ------------------------------------------------------------------
    # worker loop
    # ------------------------------------------------------------------
    def _run(self) -> None:
        eng = self.engine
        store = eng.store
        while True:
            batch = self.batcher.next_batch(timeout=0.05)
            if batch is None:
                if self._stop.is_set():
                    return
                continue
            t_start = time.monotonic()
            live, expired = [], []
            for p in batch:
                (expired if p.deadline is not None and p.deadline < t_start
                 else live).append(p)
            for p in expired:
                self.meter.observe_expired(t_start - p.t_submit)
                p.future._complete(ServeResult(
                    logits=None, status="expired",
                    queue_wait_s=t_start - p.t_submit,
                    total_s=t_start - p.t_submit))
            if not live:
                continue
            try:
                self._serve_batch(live, t_start)
            except BaseException as e:    # keep the loop alive; fail the batch
                self.meter.observe_error(len(live))
                for p in live:
                    p.future._fail(e)
            # swap point: publish a completed async refresh BETWEEN batches
            # (never mid-assembly), and
            # kick the next serving-driven refresh when due.  A FAILED
            # background build (swap_if_ready re-raises it here) must not
            # kill the loop: keep serving the live generation and surface
            # the error on the meter/server instead.
            if store is not None:
                try:
                    if store.swap_if_ready():
                        self.meter.observe_swap()
                    n_batches = self.meter.batch_count()
                    due = (self.cfg.refresh_every is not None
                           and n_batches > 0
                           and n_batches % self.cfg.refresh_every == 0)
                    if due and not store.refreshing and not self._stop.is_set():
                        store.begin_refresh(self._rng,
                                            version=store.version + 1)
                except BaseException as e:
                    with self._state_lock:   # publish to client threads
                        self.refresh_error = e
                    self.meter.observe_refresh_failure()
            if self._stop.is_set() and (not self._drain
                                        or self.batcher.qsize() == 0):
                return

    def _serve_batch(self, live: Sequence[_Pending], t_start: float) -> None:
        eng = self.engine
        ids = np.concatenate([p.node_ids for p in live])
        bucket = self.batcher.bucket_for(len(ids))
        t0 = time.perf_counter()
        if eng.store is not None:
            # serving-mode accounting: tier traffic -> the serve meter,
            # policy EMA keeps observing
            with eng.store.serving(self.meter.traffic):
                mb = eng.infer_prepare(ids, bucket=bucket, rng=self._rng)
        else:
            mb = eng.infer_prepare(ids, bucket=bucket, rng=self._rng)
        # the forward at this bucket's shapes; its host->device copy books
        # to the serving traffic meter alongside the tier accounting above
        logits = eng.infer_compute(mb, meter=self.meter.traffic)
        compute_s = time.perf_counter() - t0
        t_done = time.monotonic()
        version = mb.cache_version
        self._last_version = version
        self.meter.observe_batch(BatchRecord(
            bucket=bucket, n_requests=len(live), n_ids=len(ids),
            compute_s=compute_s, cache_version=version,
            hit_fraction=mb.num_cached / max(mb.num_input, 1)))
        lo = 0
        for p in live:
            n = len(p.node_ids)
            # copy, don't view: a view would leak the other coalesced
            # requests' rows through .base and pin the whole padded batch
            res = ServeResult(
                logits=logits[lo:lo + n].copy(), status="ok",
                queue_wait_s=t_start - p.t_submit, compute_s=compute_s,
                total_s=t_done - p.t_submit, bucket=bucket,
                cache_version=version)
            lo += n
            self.meter.observe_request(
                res.queue_wait_s, res.compute_s, res.total_s,
                late=p.deadline is not None and t_done > p.deadline)
            p.future._complete(res)

    def _cancel_queued(self) -> None:
        for p in self.batcher.drain():
            p.future._fail(ServerClosed("server stopped before serving"))
