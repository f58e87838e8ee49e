"""Serving-side accounting: per-request latency + a TrafficMeter view.

The training loop's :class:`~repro_torch.featurestore.meter.TrafficMeter` answers
"where did the bytes go"; a serving tier additionally has to answer "where
did the *milliseconds* go, per request".  :class:`ServeMeter` owns both:

* ``traffic`` — a dedicated :class:`TrafficMeter` the feature store routes
  serving lookups into (``FeatureStore.serving`` scope), so the serving
  cache-hit rate, streamed bytes and cross-shard lanes are readable without
  untangling them from training traffic;
* per-request latency records split into **queue wait** (submit → the
  micro-batcher dequeues it into a batch) and **compute** (sample + step +
  readback for the batch it rode), with p50/p99 over a bounded rolling
  window — globally AND per tenant;
* admission/outcome counters (submitted / rejected / expired / served /
  deadline_miss / errors) — the backpressure ledger, per tenant too, so
  "whose burst got shed" is a direct read;
* per-route counters (ids with a known owner shard, ids routed to the shard
  that owns them, fallback dispatches, failovers, retries) — the fabric's
  locality + failover ledger;
* the **cache-hit trajectory**: per-batch device-tier hit fraction, the
  signal that shows the adaptive policy converging onto the inference hot
  set after a serving-driven refresh.

One meter may be shared by a whole worker fleet (``ServeFabric``), so every
mutable field is written under ``lock`` via the ``observe_*`` methods — the
single-server "worker-only counters stay lock-free" carve-out is gone.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Optional

import numpy as np

from repro_torch.analysis import guarded_by, holds_lock
from repro_torch.featurestore.meter import TrafficMeter


@dataclasses.dataclass
class BatchRecord:
    """One served micro-batch (host-side bookkeeping, never traced)."""
    bucket: int                 # padded batch size shipped to the device
    n_requests: int             # requests coalesced into it
    n_ids: int                  # real target rows (<= bucket)
    compute_s: float            # sample + forward + readback
    cache_version: int          # generation the batch was pinned to (-1 none)
    hit_fraction: float         # device-tier hits / requested input nodes


class TenantStats:
    """One tenant's slice of the ledger (mutated only under the owning
    :class:`ServeMeter`'s lock — never annotated or locked itself)."""

    # counter names are n_-prefixed, as in repro.serve.metrics: the bare
    # names belong to ServeMeter's @guarded_by annotation
    __slots__ = ("n_submitted", "n_rejected", "n_served", "n_expired",
                 "n_deadline_miss", "n_retries", "queue_wait", "compute",
                 "total")

    def __init__(self, latency_window: int):
        self.n_submitted = 0
        self.n_rejected = 0
        self.n_served = 0
        self.n_expired = 0
        self.n_deadline_miss = 0
        self.n_retries = 0          # failover re-routes of this tenant's
                                    # requests
        self.queue_wait: Deque[float] = collections.deque(
            maxlen=latency_window)
        self.compute: Deque[float] = collections.deque(maxlen=latency_window)
        self.total: Deque[float] = collections.deque(maxlen=latency_window)

    def as_dict(self) -> dict:
        out = {"submitted": self.n_submitted, "rejected": self.n_rejected,
               "served": self.n_served, "expired": self.n_expired,
               "deadline_miss": self.n_deadline_miss,
               "retries": self.n_retries}
        out.update(_latency_percentiles(
            (("queue_wait", self.queue_wait), ("compute", self.compute),
             ("total", self.total))))
        return out


def _latency_percentiles(named_bufs) -> dict:
    out = {}
    for name, buf in named_bufs:
        if buf:
            arr = np.asarray(buf, dtype=np.float64)
            out[f"{name}_p50_ms"] = round(
                float(np.percentile(arr, 50)) * 1e3, 3)
            out[f"{name}_p99_ms"] = round(
                float(np.percentile(arr, 99)) * 1e3, 3)
        else:
            out[f"{name}_p50_ms"] = out[f"{name}_p99_ms"] = None
    return out


# NOTE: ``padded_rows`` is missing from the annotation, as in
# repro.serve.metrics; it is still only ever written under ``lock``
# (observe_batch).
@guarded_by("lock", "submitted", "rejected", "expired", "served",
            "deadline_miss", "errors", "refresh_failures", "batches",
            "real_rows", "swaps_observed", "routed_known_ids",
            "routed_local_ids", "route_fallbacks", "failovers",
            "retries_total", "tenant_stats", "worker_batches",
            "remote_worker_stats")
class ServeMeter:
    """Latency + traffic accounting for one server or one worker fleet.

    Every counter may be written from arbitrary threads (client submit
    paths, N fabric workers, the watchdog), so ALL mutation goes through
    ``observe_*`` methods that take ``lock``; readers (``snapshot``,
    ``percentiles``) lock too.  The exception is ``traffic``: the fabric
    serializes sampling under its sample lock, so the TrafficMeter keeps
    its lock-free single-writer contract.
    """

    def __init__(self, latency_window: int = 2048):
        self.traffic = TrafficMeter()       # serving-side tier view
        self.lock = threading.Lock()
        self.latency_window = latency_window
        self.submitted = 0
        self.rejected = 0                   # admission control (queue full)
        self.expired = 0                    # deadline passed while queued
        self.served = 0
        self.deadline_miss = 0              # served, but past its deadline
        self.errors = 0
        self.refresh_failures = 0           # failed serving-driven builds
        self.batches = 0
        self.padded_rows = 0                # sum of buckets shipped
        self.real_rows = 0                  # sum of real target rows
        self.swaps_observed = 0             # generation adoptions mid-stream
        # fabric routing/failover ledger
        self.routed_known_ids = 0           # ids with a known owner shard
        self.routed_local_ids = 0           # of those, routed to their owner
        self.route_fallbacks = 0            # least-loaded dispatches
        self.failovers = 0                  # workers taken out of rotation
        self.retries_total = 0              # requests re-routed after a
                                            # stall/death
        self.tenant_stats: dict = {}        # name -> TenantStats
        self.worker_batches: dict = {}      # worker index -> batches served
        self.remote_worker_stats: dict = {} # worker index -> endpoint-side
                                            # stats dict (tcp transport:
                                            # absorbed via STATS frames so
                                            # per-tenant ledgers aggregate
                                            # across hosts)
        self._queue_wait: Deque[float] = collections.deque(maxlen=latency_window)
        self._compute: Deque[float] = collections.deque(maxlen=latency_window)
        self._total: Deque[float] = collections.deque(maxlen=latency_window)
        self._rpc_wait: Deque[float] = collections.deque(maxlen=latency_window)
                                            # tcp transport: per-request wire
                                            # + (de)serialization time — the
                                            # RPC-vs-compute latency split
        self.batch_log: Deque[BatchRecord] = collections.deque(maxlen=latency_window)

    # ------------------------------------------------------------------
    @holds_lock("lock")
    def _tenant_locked(self, name: str) -> TenantStats:
        ts = self.tenant_stats.get(name)
        if ts is None:
            ts = self.tenant_stats[name] = TenantStats(
                min(self.latency_window, 512))
        return ts

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def observe_submit(self, tenant: Optional[str] = None) -> None:
        with self.lock:
            self.submitted += 1
            if tenant is not None:
                self._tenant_locked(tenant).n_submitted += 1

    def observe_reject(self, tenant: Optional[str] = None) -> None:
        with self.lock:
            self.rejected += 1
            if tenant is not None:
                self._tenant_locked(tenant).n_rejected += 1

    def observe_expired(self, queue_wait_s: float,
                        tenant: Optional[str] = None) -> None:
        with self.lock:
            self.expired += 1
            if tenant is not None:
                ts = self._tenant_locked(tenant)
                ts.n_expired += 1
                ts.queue_wait.append(queue_wait_s)

    def observe_error(self, n_requests: int = 1) -> None:
        with self.lock:
            self.errors += n_requests

    # ------------------------------------------------------------------
    # completion
    # ------------------------------------------------------------------
    def observe_request(self, queue_wait_s: float, compute_s: float,
                        total_s: float, tenant: Optional[str] = None,
                        late: bool = False,
                        rpc_s: Optional[float] = None) -> None:
        with self.lock:
            self.served += 1
            if late:
                self.deadline_miss += 1
            if rpc_s is not None:
                self._rpc_wait.append(rpc_s)
            self._queue_wait.append(queue_wait_s)
            self._compute.append(compute_s)
            self._total.append(total_s)
            if tenant is not None:
                ts = self._tenant_locked(tenant)
                ts.n_served += 1
                if late:
                    ts.n_deadline_miss += 1
                ts.queue_wait.append(queue_wait_s)
                ts.compute.append(compute_s)
                ts.total.append(total_s)

    def observe_batch(self, rec: BatchRecord,
                      worker: Optional[int] = None) -> None:
        with self.lock:
            self.batches += 1
            self.padded_rows += rec.bucket
            self.real_rows += rec.n_ids
            self.batch_log.append(rec)
            if worker is not None:
                self.worker_batches[worker] = \
                    self.worker_batches.get(worker, 0) + 1

    # ------------------------------------------------------------------
    # fabric: routing / failover / generation events
    # ------------------------------------------------------------------
    def observe_route(self, known: int, local: int,
                      fallback: bool = False) -> None:
        with self.lock:
            self.routed_known_ids += known
            self.routed_local_ids += local
            if fallback:
                self.route_fallbacks += 1

    def observe_failover(self) -> None:
        with self.lock:
            self.failovers += 1

    def observe_retry(self, tenant: Optional[str] = None) -> None:
        with self.lock:
            self.retries_total += 1
            if tenant is not None:
                self._tenant_locked(tenant).n_retries += 1

    def observe_swap(self) -> None:
        with self.lock:
            self.swaps_observed += 1

    def observe_refresh_failure(self) -> None:
        with self.lock:
            self.refresh_failures += 1

    def observe_remote_stats(self, worker: int, stats: dict) -> None:
        """Absorb one endpoint's STATS reply (tcp transport): the remote
        per-tenant ledger + wire counters, keyed by worker index, so a
        cross-host fleet still has ONE aggregation point."""
        with self.lock:
            self.remote_worker_stats[worker] = dict(stats)

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    def batch_count(self) -> int:
        with self.lock:
            return self.batches

    @property
    def cache_hit_rate(self) -> float:
        """Device-tier hit rate over ALL serving lookups so far."""
        return self.traffic.tier("device").hit_rate

    def hit_trajectory(self) -> list:
        """Per-batch device-tier hit fraction, oldest first."""
        with self.lock:
            return [r.hit_fraction for r in self.batch_log]

    def generation_trail(self) -> list:
        """Per-batch pinned cache version, oldest first (monotonic by the
        adoption contract — asserted in tests/test_gns_server.py)."""
        with self.lock:
            return [r.cache_version for r in self.batch_log]

    @property
    def fill_fraction(self) -> float:
        """Real rows / padded rows shipped — micro-batching efficiency."""
        with self.lock:
            rows = self.real_rows
            padded = self.padded_rows
        return rows / padded if padded else 0.0

    @property
    def route_local_fraction(self) -> float:
        """Of the ids with a known owner shard, the fraction that was routed
        to the worker whose home shard owns them."""
        with self.lock:
            known, local = self.routed_known_ids, self.routed_local_ids
        return local / known if known else 0.0

    def percentiles(self) -> dict:
        with self.lock:
            named = [("queue_wait", self._queue_wait),
                     ("compute", self._compute),
                     ("total", self._total)]
            if self._rpc_wait:
                named.append(("rpc_wait", self._rpc_wait))
            return _latency_percentiles(named)

    def tenant_snapshot(self) -> dict:
        """Per-tenant ledger: counters + p50/p99, JSON-safe."""
        with self.lock:
            return {name: ts.as_dict()
                    for name, ts in sorted(self.tenant_stats.items())}

    def snapshot(self) -> dict:
        """JSON-safe summary (what `bench_serve` and the example print)."""
        with self.lock:
            real, padded = self.real_rows, self.padded_rows
            known, local = self.routed_known_ids, self.routed_local_ids
            out = {
                "submitted": self.submitted, "served": self.served,
                "rejected": self.rejected, "expired": self.expired,
                "deadline_miss": self.deadline_miss, "errors": self.errors,
                "refresh_failures": self.refresh_failures,
                "batches": self.batches,
                "fill_fraction": round(real / padded if padded else 0.0, 4),
                "swaps_observed": self.swaps_observed,
                **_latency_percentiles(
                    (("queue_wait", self._queue_wait),
                     ("compute", self._compute),
                     ("total", self._total))),
            }
            if self._rpc_wait:
                out.update(_latency_percentiles(
                    (("rpc_wait", self._rpc_wait),)))
            if self.remote_worker_stats:
                out["remote"] = {str(k): v for k, v in sorted(
                    self.remote_worker_stats.items())}
            if self.tenant_stats:
                out["tenants"] = {name: ts.as_dict()
                                  for name, ts in
                                  sorted(self.tenant_stats.items())}
            if known or self.route_fallbacks or self.failovers:
                out["routing"] = {
                    "route_local_fraction":
                        round(local / known if known else 0.0, 4),
                    "routed_known_ids": known,
                    "route_fallbacks": self.route_fallbacks,
                    "failovers": self.failovers,
                    "retries": self.retries_total,
                    "worker_batches": dict(sorted(
                        self.worker_batches.items())),
                }
        out["cache_hit_rate"] = round(self.cache_hit_rate, 4)
        out["traffic"] = self.traffic.breakdown()
        return out
