"""Port parity of the fabric's engine-free parts: ``FairScheduler``
(``serve/tenancy.py``) and ``Router`` (``serve/router.py``) against the
reference's, plus the port's bounded ``RoutingTable.owners``.

The same random sequence of calls goes to a reference object and a port
object built alike; every return value, ``depths()``, ``counters()`` and
``loads()`` must be equal at every step.
"""
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                          # pragma: no cover
    from _hypothesis_fallback import given, settings, st

from repro.featurestore import RoutingTable as RoutingTableRef
from repro.gns.config import TenantConfig as TenantConfigRef
from repro.serve import FairScheduler as FairSchedulerRef
from repro.serve import Router as RouterRef
from repro.serve import UnknownTenant as UnknownTenantRef
from repro_torch.featurestore import RoutingTable
from repro_torch.gns.config import TenantConfig
from repro_torch.serve import (FairScheduler, RouteDecision, Router,
                               UnknownTenant)

OPS = st.lists(st.tuples(st.sampled_from(["offer", "offer", "offer", "pop",
                                          "pop", "push_front", "drain",
                                          "qsize"]),
                         st.integers(0, 5)),
               min_size=1, max_size=120)


def _pair(weights, quotas, auto_register=True, default_quota=4):
    ref = FairSchedulerRef(
        [TenantConfigRef(f"t{i}", weight=w, max_queue=q)
         for i, (w, q) in enumerate(zip(weights, quotas))],
        default_quota=default_quota, auto_register=auto_register)
    port = FairScheduler(
        [TenantConfig(f"t{i}", weight=w, max_queue=q)
         for i, (w, q) in enumerate(zip(weights, quotas))],
        default_quota=default_quota, auto_register=auto_register)
    return ref, port


def _step(sched, op, arg, item, popped):
    """One call; returns what it gave back (errors by class name)."""
    tenant = f"t{arg}"
    try:
        if op == "offer":
            return sched.offer(tenant, item)
        if op == "pop":
            out = sched.pop()
            if out is not None:
                popped.append(out)
            return out
        if op == "push_front":
            if not popped:
                return None
            name, it = popped.pop()
            sched.push_front(name, it)
            return name, it
        if op == "drain":
            return sorted(sched.drain())
        return sched.qsize(tenant), sched.qsize()
    except (UnknownTenant, UnknownTenantRef):
        return "UnknownTenant"


@settings(max_examples=40, deadline=None)
@given(weights=st.lists(st.floats(0.25, 8.0), min_size=1, max_size=4),
       quotas=st.lists(st.integers(1, 12), min_size=4, max_size=4),
       auto=st.booleans(), ops=OPS)
def test_scheduler_call_sequences_match_reference(weights, quotas, auto,
                                                  ops):
    ref, port = _pair(weights, quotas[:len(weights)], auto_register=auto)
    popped_ref, popped_port = [], []
    for i, (op, arg) in enumerate(ops):
        got_ref = _step(ref, op, arg, i, popped_ref)
        got_port = _step(port, op, arg, i, popped_port)
        assert got_ref == got_port, (i, op, arg)
        assert ref.depths() == port.depths()
        assert ref.counters() == port.counters()
        assert ref.work_ev.is_set() == port.work_ev.is_set()
    for t in ref.depths():
        assert ref.weight(t) == port.weight(t)


def test_scheduler_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        FairScheduler([TenantConfig("bad", weight=0.0)])
    sched = FairScheduler([TenantConfig("a")], auto_register=False)
    with pytest.raises(UnknownTenant):
        sched.offer("ghost", 1)


def _table(cls, rng, v, n_shards, coverage):
    shard = rng.integers(0, n_shards, v).astype(np.int16)
    shard[rng.random(v) > coverage] = -1
    return cls(shard_of_node=shard, n_shards=n_shards,
               version=int(rng.integers(0, 5)))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), workers=st.integers(1, 4),
       n_shards=st.integers(1, 4), coverage=st.floats(0.0, 1.0),
       mode=st.sampled_from(["locality", "spread"]),
       no_table=st.booleans(), n_req=st.integers(1, 60))
def test_router_decisions_match_reference(seed, workers, n_shards, coverage,
                                          mode, no_table, n_req):
    rng = np.random.default_rng(seed)
    v = int(rng.integers(1, 200))
    t_ref = None if no_table else _table(RoutingTableRef,
                                         np.random.default_rng(seed), v,
                                         n_shards, coverage)
    t_port = None if no_table else _table(RoutingTable,
                                          np.random.default_rng(seed), v,
                                          n_shards, coverage)
    ref = RouterRef(range(workers), n_shards, table=t_ref, mode=mode)
    port = Router(range(workers), n_shards, table=t_port, mode=mode)
    assert ref.homes == port.homes
    assert ref.table_version == port.table_version
    for _ in range(n_req):
        ids = rng.integers(0, v, int(rng.integers(1, 12)))
        healthy = sorted(rng.choice(workers, int(rng.integers(1, workers + 1)),
                                    replace=False).tolist())
        d_ref = ref.route(ids, healthy)
        d_port = port.route(ids, healthy)
        assert (d_ref.worker, d_ref.known, d_ref.local, d_ref.fallback) == \
            (d_port.worker, d_port.known, d_port.local, d_port.fallback)
        np.testing.assert_array_equal(ref.loads(), port.loads())
        if rng.random() < 0.1:          # a generation swap re-adopts
            s = int(rng.integers(2 ** 31))
            ref.adopt(_table(RoutingTableRef, np.random.default_rng(s), v,
                             n_shards, coverage))
            port.adopt(_table(RoutingTable, np.random.default_rng(s), v,
                              n_shards, coverage))
            assert ref.table_version == port.table_version


def test_owners_past_the_table_are_unowned():
    """A node a merge added after the table's generation was built: the
    port routes it least-loaded; the reference's unbounded index raises."""
    v = 50
    shard = np.zeros(v, np.int16)
    shard[v // 2:] = 1
    port = Router([0, 1], 2, table=RoutingTable(shard, 2, 0))
    ref = RouterRef([0, 1], 2, table=RoutingTableRef(shard, 2, 0))
    assert port.route(np.array([v]), [0, 1]) == RouteDecision(
        worker=0, known=0, local=0, fallback=True)
    with pytest.raises(IndexError):
        ref.route(np.array([v]), [0, 1])
    # mixed: the known ids still vote, the new one counts as unknown
    d = port.route(np.array([v + 3, v - 1, v - 2]), [0, 1])
    assert (d.worker, d.known, d.local, d.fallback) == (1, 2, 2, False)
    np.testing.assert_array_equal(
        RoutingTable(shard, 2, 0).owners(np.array([0, v - 1, v, 10 * v])),
        [0, 1, -1, -1])


def test_scheduler_and_router_under_contending_threads():
    """More threads than cores offer, pop, push back and route at once,
    with a short switch interval: no item is lost or served twice, and the
    counters and loads add up (a lost update would break either)."""
    import sys
    import threading
    n_threads, per_thread = 16, 1000
    sched = FairScheduler([TenantConfig(f"t{i}", weight=1.0 + i,
                                        max_queue=10 ** 6)
                           for i in range(4)])
    router = Router(range(3), 1)
    popped, pop_lock = [], threading.Lock()
    start = threading.Barrier(n_threads)

    def work(k):
        start.wait(timeout=30)
        for j in range(per_thread):
            assert sched.offer(f"t{(k + j) % 4}", (k, j))
            router.route(np.array([j]), [0, 1, 2])
            got = sched.pop()
            if got is not None and j % 7 == 0:
                sched.push_front(*got)          # refused by a batcher
            elif got is not None:
                with pop_lock:
                    popped.append(got[1])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rest = [item for _t, item in sched.drain()]
    items = popped + rest
    assert len(items) == len(set(items)) == n_threads * per_thread
    counters = sched.counters()
    assert sum(c["offered"] for c in counters.values()) == \
        n_threads * per_thread
    assert int(router.loads().sum()) == n_threads * per_thread
