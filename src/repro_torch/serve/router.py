"""Placement-aware request routing for the serve fabric (port of
``repro.serve.router``).

Worker ``w`` serves DP group ``w``, whose fused lookups resolve locally on
home shard ``home_shard(w, n_shards)`` — so the worker that should serve a
request is the one whose home shard owns the most of the request's cached
rows.  :class:`Router` scores each healthy worker by that ownership count
against the store's :class:`~repro_torch.featurestore.RoutingTable` (re-adopted
at every generation swap) and picks the argmax, breaking ties toward the
least-loaded worker.

The feedback loop that makes this converge: routed requests land on their
worker's DP-group histogram (``TrafficMeter.observe_group`` inside the
serving scope), the placement solver's next generation moves each hot row
to the home shard of the group that requested it most, and the refreshed
routing table then scores those rows as local to that worker — skewed
per-tenant traffic ends up pinned worker-local without anyone declaring a
partition up front.

When there is no table yet (cold store, meshless engine, or
``routing="spread"``) the router degrades to least-loaded dispatch.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.analysis import guarded_by
from repro_torch.featurestore import RoutingTable, home_shard


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Where one request goes, and why (feeds the per-route meter)."""
    worker: int
    known: int = 0          # ids with a known owner shard
    local: int = 0          # of those, ids the chosen worker's shard owns
    fallback: bool = False  # True = least-loaded dispatch (no table/votes)


@guarded_by("_rlock", "_routed_load", writes_only=("_rtable",))
class Router:
    """Pick a worker per request: ownership vote, least-loaded fallback.

    ``_rtable`` is swapped whole under ``_rlock`` and read as a lock-free
    snapshot (the frozen :class:`RoutingTable` is immutable); the
    per-worker dispatch counters live under the lock.
    """

    def __init__(self, worker_groups: Sequence[int], n_shards: int,
                 table: Optional[RoutingTable] = None,
                 mode: str = "locality"):
        assert mode in ("locality", "spread"), mode
        self._rlock = threading.Lock()
        self._rtable = table
        self.mode = mode
        self.worker_groups = tuple(int(g) for g in worker_groups)
        self.n_shards = max(int(n_shards), 1)
        self.homes = tuple(home_shard(g, self.n_shards)
                           for g in self.worker_groups)
        self._routed_load = np.zeros(len(self.worker_groups), dtype=np.int64)

    # ------------------------------------------------------------------
    def adopt(self, table: Optional[RoutingTable]) -> None:
        """Swap in a freshly derived table (generation-swap hook)."""
        with self._rlock:
            self._rtable = table

    @property
    def table_version(self) -> int:
        t = self._rtable
        return t.version if t is not None else -1

    # ------------------------------------------------------------------
    def route(self, node_ids: np.ndarray,
              healthy: Sequence[int]) -> RouteDecision:
        """Choose one of ``healthy`` (worker indices) for this request."""
        assert healthy, "route() with no healthy workers"
        table = self._rtable             # lock-free snapshot (writes_only)
        if (self.mode == "locality" and table is not None
                and self.n_shards > 1):
            owners = table.owners(node_ids)
            known = int((owners >= 0).sum())
            if known:
                votes = [int((owners == self.homes[w]).sum())
                         for w in healthy]
                top = max(votes)
                if top > 0:
                    with self._rlock:
                        tied = [w for w, v in zip(healthy, votes)
                                if v == top]
                        w = min(tied, key=lambda i: (self._routed_load[i], i))
                        self._routed_load[w] += 1
                    return RouteDecision(worker=w, known=known, local=top)
        # fallback: least-loaded healthy worker (deterministic tie-break)
        with self._rlock:
            w = min(healthy, key=lambda i: (self._routed_load[i], i))
            self._routed_load[w] += 1
        return RouteDecision(worker=w, fallback=True)

    def loads(self) -> np.ndarray:
        """Requests dispatched per worker so far (observability)."""
        with self._rlock:
            return self._routed_load.copy()
