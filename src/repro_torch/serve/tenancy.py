"""Per-tenant admission + weighted-fair scheduling for the serve fabric
(port of ``repro.serve.tenancy``).

One :class:`FairScheduler` sits in front of each fabric worker's
micro-batcher.  It answers two questions the single-server bounded queue
could not:

* **whose request is refused** when the system saturates — every tenant has
  its own bounded queue (``TenantConfig.max_queue``), so a flooding tenant
  collects its own :class:`~repro_torch.serve.server.QueueFull` while everyone
  else's admissions are untouched; and
* **whose request runs next** — classic stride scheduling: each tenant
  carries a ``pass`` value advanced by ``stride ∝ 1/weight`` per dequeue,
  and the scheduler always pops the FIFO head of the minimum-pass non-empty
  tenant.  Under saturation, throughput share converges to the weight
  ratio; any positive-weight tenant is dequeued after at most
  ``ceil(total_weight / weight)`` pops (no starvation); requests within one
  tenant never reorder.

A tenant rejoining after idling restarts at ``max(own pass, global virtual
time)`` — it cannot hoard credit while idle and then monopolize the worker
(the standard stride-scheduling rejoin rule).

The scheduler is engine-free: items are opaque, so its invariants can be
driven property-style with plain integers, and the same sequence of calls
gives the reference's items, depths and counters.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict, Optional, Sequence, Tuple

from repro_torch.analysis import guarded_by, holds_lock

# pass/virtual-time quantum for a weight-1.0 tenant; only ratios matter
_STRIDE1 = float(1 << 20)


class UnknownTenant(KeyError):
    """offer() for a tenant that is not declared (auto-register disabled)."""


@guarded_by("_slock", "_tq", "_tpass", "_tweight", "_tstride", "_tquota",
            "_torder", "_vtime", "_toffered", "_tpopped")
class FairScheduler:
    """Weighted-fair (stride) scheduler over per-tenant bounded FIFOs.

    All state lives under ``_slock``; the public surface is ``offer`` /
    ``pop`` / ``drain`` / ``qsize``.  ``work_ev`` is a plain Event a worker
    may wait on instead of polling — set whenever any queue is non-empty
    (a lost wakeup is bounded by the worker's wait timeout, never dropped
    work).
    """

    def __init__(self, tenants: Sequence[Any] = (),
                 default_weight: float = 1.0, default_quota: int = 64,
                 auto_register: bool = True):
        self._slock = threading.Lock()
        self._tq: Dict[str, Deque[Any]] = {}
        self._tpass: Dict[str, float] = {}
        self._tweight: Dict[str, float] = {}
        self._tstride: Dict[str, float] = {}
        self._tquota: Dict[str, int] = {}
        self._torder: Dict[str, int] = {}   # registration rank: pass ties
                                            # break deterministically
        self._toffered: Dict[str, int] = {} # admitted offers per tenant
        self._tpopped: Dict[str, int] = {}  # fair-order dispatches per
                                            # tenant (cross-host fleets
                                            # aggregate these per proxy)
        self._vtime = 0.0                   # global virtual time (last pass
                                            # dispatched)
        self.default_weight = float(default_weight)
        self.default_quota = int(default_quota)
        self.auto_register = auto_register
        self.work_ev = threading.Event()
        with self._slock:
            for t in tenants:
                self._register_locked(t.name, weight=t.weight,
                                      quota=t.max_queue)

    # ------------------------------------------------------------------
    @holds_lock("_slock")
    def _register_locked(self, name: str, weight: Optional[float] = None,
                         quota: Optional[int] = None) -> None:
        w = self.default_weight if weight is None else float(weight)
        if w <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        self._tq[name] = collections.deque()
        self._tweight[name] = w
        self._tstride[name] = _STRIDE1 / w
        self._tquota[name] = int(self.default_quota if quota is None
                                 else quota)
        self._tpass[name] = self._vtime
        self._torder[name] = len(self._torder)
        self._toffered[name] = 0
        self._tpopped[name] = 0

    # ------------------------------------------------------------------
    def offer(self, tenant: str, item: Any) -> bool:
        """Enqueue ``item`` for ``tenant``; False = that tenant's queue is
        at quota (admission control — reject, never grow)."""
        with self._slock:
            q = self._tq.get(tenant)
            if q is None:
                if not self.auto_register:
                    raise UnknownTenant(tenant)
                self._register_locked(tenant)
                q = self._tq[tenant]
            if len(q) >= self._tquota[tenant]:
                return False
            if not q:
                # rejoin after idle: no hoarded credit
                self._tpass[tenant] = max(self._tpass[tenant], self._vtime)
            q.append(item)
            self._toffered[tenant] += 1
            self.work_ev.set()
            return True

    def push_front(self, tenant: str, item: Any) -> None:
        """Return an item to the head of its tenant queue (a worker pumped
        it but the batcher refused) — preserves FIFO, ignores quota (the
        item was already admitted once)."""
        with self._slock:
            if tenant not in self._tq:
                self._register_locked(tenant)
            self._tq[tenant].appendleft(item)
            self.work_ev.set()

    def pop(self) -> Optional[Tuple[str, Any]]:
        """Dequeue the FIFO head of the minimum-pass non-empty tenant, or
        None when everything is empty."""
        with self._slock:
            best = None
            for name, q in self._tq.items():
                if not q:
                    continue
                key = (self._tpass[name], self._torder[name])
                if best is None or key < best[0]:
                    best = (key, name)
            if best is None:
                self.work_ev.clear()
                return None
            name = best[1]
            item = self._tq[name].popleft()
            self._tpopped[name] += 1
            self._vtime = self._tpass[name]
            self._tpass[name] += self._tstride[name]
            if not any(self._tq.values()):
                self.work_ev.clear()
            return name, item

    # ------------------------------------------------------------------
    def qsize(self, tenant: Optional[str] = None) -> int:
        with self._slock:
            if tenant is not None:
                q = self._tq.get(tenant)
                return len(q) if q is not None else 0
            return sum(len(q) for q in self._tq.values())

    def drain(self) -> list:
        """Remove and return every queued (tenant, item), fair order not
        preserved — failover/shutdown sweep."""
        with self._slock:
            out = []
            for name, q in self._tq.items():
                while q:
                    out.append((name, q.popleft()))
            self.work_ev.clear()
            return out

    def weight(self, tenant: str) -> float:
        with self._slock:
            return self._tweight.get(tenant, self.default_weight)

    def depths(self) -> dict:
        """Per-tenant queue depth snapshot (observability)."""
        with self._slock:
            return {name: len(q) for name, q in self._tq.items()}

    def counters(self) -> dict:
        """Per-tenant admitted/dispatched totals — the fair-share ledger a
        multi-host fleet sums across its per-proxy schedulers (each remote
        worker's fair order is applied coordinator-side, so these ARE the
        cross-host dispatch counts)."""
        with self._slock:
            return {name: {"offered": self._toffered.get(name, 0),
                           "popped": self._tpopped.get(name, 0),
                           "queued": len(q)}
                    for name, q in self._tq.items()}
