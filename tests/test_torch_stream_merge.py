"""Port parity of streaming ingest's host-side units: ``merge_delta_csr``
(bitwise), ``DeltaBuffer`` (admission, seqs, new-node ids, ``drain()``,
``state()`` / ``restore()``) and ``temporal_event_stream``, each against the
reference on the same numpy inputs.
"""
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                          # pragma: no cover
    from _hypothesis_fallback import given, settings, st

from repro.data import temporal_event_stream as temporal_ref
from repro.graph.csr import CSRGraph as CSRGraphRef
from repro.graph.datasets import get_dataset as get_dataset_ref
from repro.serve.server import QueueFull as QueueFullRef
from repro.stream import DeltaBuffer as DeltaBufferRef
from repro.stream import merge_delta_csr as merge_ref
from repro_torch.data import temporal_event_stream
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.datasets import get_dataset
from repro_torch.serve.server import QueueFull
from repro_torch.stream import DeltaBatch, DeltaBuffer, merge_delta_csr

BATCH_FIELDS = ("edge_src", "edge_dst", "edge_op", "edge_seq", "node_feats",
                "node_labels")


def _ops(seed, v, n_ops, n_new, feat_dim=3):
    """A random op log over ``v`` old and ``n_new`` new nodes: inserts,
    deletes of existing and absent edges, duplicates, conflicting ops on
    one edge, self-loops.  Returns a list of (kind, args)."""
    rng = np.random.default_rng(seed)
    log = []
    if n_new:
        log.append(("nodes", (rng.normal(size=(n_new, feat_dim))
                              .astype(np.float32),
                              rng.integers(0, 5, n_new))))
    hi = v + n_new
    for _ in range(n_ops):
        k = int(rng.integers(1, 6))
        src = rng.integers(0, hi, k)
        dst = rng.integers(0, hi, k)
        if rng.random() < 0.2:                      # repeat an earlier edge
            src, dst = np.repeat(src[:1], k), np.repeat(dst[:1], k)
        log.append(("insert" if rng.random() < 0.6 else "delete",
                    (src, dst)))
    return log


def _stage(buf, log):
    out = []
    for kind, args in log:
        if kind == "nodes":
            out.append(buf.add_nodes(*args))
        elif kind == "insert":
            out.append(buf.add_edges(*args))
        else:
            out.append(buf.delete_edges(*args))
    return out


def _assert_batches_equal(a, b):
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.node_base, a.first_seq, a.last_seq, a.num_ops,
            a.num_new_nodes, a.payload_bytes) == (
        b.node_base, b.first_seq, b.last_seq, b.num_ops, b.num_new_nodes,
        b.payload_bytes)


def _assert_graphs_equal(a, b):
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.degrees, b.degrees)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), v=st.integers(2, 60),
       n_edges=st.integers(0, 200), n_ops=st.integers(0, 30),
       n_new=st.integers(0, 5), symmetrize=st.booleans())
def test_merge_is_bitwise_the_reference(seed, v, n_edges, n_ops, n_new,
                                        symmetrize):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, v, n_edges), rng.integers(0, v, n_edges)
    g_ref = CSRGraphRef.from_edges(src, dst, v)
    g = CSRGraph.from_edges(src, dst, v)
    log = _ops(seed + 1, v, n_ops, n_new)
    b_ref, b = DeltaBufferRef(v, 3), DeltaBuffer(v, 3)
    _stage(b_ref, log)
    _stage(b, log)
    batch_ref, batch = b_ref.drain(), b.drain()
    if batch_ref is None:
        assert batch is None and not log
        return
    _assert_batches_equal(batch_ref, batch)
    out_ref = merge_ref(g_ref, batch_ref, symmetrize=symmetrize)
    out = merge_delta_csr(g, batch, symmetrize=symmetrize)
    assert out.num_nodes == v + n_new
    _assert_graphs_equal(out_ref, out)
    # the input graph is never mutated
    np.testing.assert_array_equal(g.indptr, g_ref.indptr)


@pytest.mark.parametrize("symmetrize", [True, False])
def test_merge_edge_cases_match_reference(symmetrize):
    """Insert-then-delete, delete-then-insert (last op wins), a duplicate
    insert of an existing edge, a delete of an absent edge, a self-loop,
    and new nodes wired to old ones — spelled out, not drawn."""
    v = 6
    g_ref = CSRGraphRef.from_edges(np.array([0, 1, 2]), np.array([1, 2, 3]),
                                   v)
    g = CSRGraph.from_edges(np.array([0, 1, 2]), np.array([1, 2, 3]), v)
    outs = []
    for buf_cls, graph, merge in ((DeltaBufferRef, g_ref, merge_ref),
                                  (DeltaBuffer, g, merge_delta_csr)):
        buf = buf_cls(v, 2)
        new = buf.add_nodes(np.ones((2, 2), np.float32), labels=[1, 2])
        buf.add_edges([4, 0, 5], [5, 1, 5])      # new, duplicate, self-loop
        buf.delete_edges([4, 3], [5, 4])         # 4-5 deleted, 3-4 absent
        buf.add_edges([4], [5])                  # ... and back: last wins
        buf.delete_edges([1], [2])
        buf.add_edges([1, int(new[0]), int(new[1])], [2, 0, 1])
        buf.delete_edges([1], [2])               # 1-2 ends deleted
        outs.append(merge(graph, buf.drain(), symmetrize=symmetrize))
    _assert_graphs_equal(*outs)
    e = set(zip(np.repeat(np.arange(8), outs[1].degrees).tolist(),
                outs[1].indices.tolist()))
    assert (4, 5) in e and (1, 2) not in e and (6, 0) in e and (5, 5) not in e


def test_buffer_matches_reference_step_by_step():
    """Bounded admission (the port's QueueFull), monotonic seqs, contiguous
    new-node ids, drain(), and state()/restore() bitwise."""
    rng = np.random.default_rng(3)
    v, f = 20, 4
    ref, port = DeltaBufferRef(v, f, max_pending=25), \
        DeltaBuffer(v, f, max_pending=25)
    for step in range(40):
        kind = ["edges", "delete", "nodes", "state", "drain"][
            int(rng.integers(5))]
        n = int(rng.integers(1, 6))
        results = []
        for buf, qfull in ((ref, QueueFullRef), (port, QueueFull)):
            r = np.random.default_rng(step)
            hi = buf.next_node
            try:
                if kind == "edges":
                    results.append(buf.add_edges(r.integers(0, hi, n),
                                                 r.integers(0, hi, n)))
                elif kind == "delete":
                    results.append(buf.delete_edges(r.integers(0, hi, n),
                                                    r.integers(0, hi, n)))
                elif kind == "nodes":
                    results.append(buf.add_nodes(
                        r.normal(size=(n, f)), r.integers(0, 3, n)))
                elif kind == "state":
                    results.append(buf.state())
                else:
                    results.append(buf.drain())
            except qfull:
                results.append("QueueFull")
        a, b = results
        if kind == "nodes" and not isinstance(a, str):
            np.testing.assert_array_equal(a, b)
            assert b.dtype == np.int64 and (np.diff(b) == 1).all()
        elif kind == "state":
            assert a.keys() == b.keys()
            for k in a:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif kind == "drain":
            if a is None:
                assert b is None
            else:
                _assert_batches_equal(a, b)
                assert (np.diff(b.edge_seq) > 0).all()
        else:
            assert a == b, (step, kind, a, b)
        assert (ref.pending(), ref.next_node, ref.admitted, ref.rejected,
                ref.drains) == (port.pending(), port.next_node,
                                port.admitted, port.rejected, port.drains)
    assert port.rejected > 0 and port.drains > 0


def test_buffer_state_restore_roundtrip_bitwise():
    log = _ops(5, 12, 10, 3, feat_dim=4)
    ref, port = DeltaBufferRef(12, 4), DeltaBuffer(12, 4)
    _stage(ref, log)
    _stage(port, log)
    st_ref = ref.state()
    # the reference's snapshot restores into the port and the other way
    port2, ref2 = DeltaBuffer(12, 4), DeltaBufferRef(12, 4)
    port2.restore(st_ref)
    ref2.restore(port.state())
    for a, b in ((ref, port2), (ref2, port)):
        _assert_batches_equal(a.drain(), b.drain())
    empty = DeltaBuffer(7, 2).state()
    again = DeltaBuffer(7, 2)
    again.restore(empty)
    assert again.pending() == 0 and again.drain() is None
    with pytest.raises(AssertionError):
        DeltaBuffer(3, 2).add_edges([0], [3])     # past the id space


@pytest.mark.parametrize("new_node_frac", [0.0, 0.15])
def test_temporal_event_stream_matches_reference(new_node_frac):
    ds_ref, ds = get_dataset_ref("tiny", seed=0), get_dataset("tiny", seed=0)
    a = temporal_ref(ds_ref, num_batches=4, events_per_batch=32,
                     new_node_frac=new_node_frac, seed=11)
    b = temporal_event_stream(ds, num_batches=4, events_per_batch=32,
                              new_node_frac=new_node_frac, seed=11)
    assert (len(a), a.base_nodes, a.total_events, a.total_new_nodes) == \
        (len(b), b.base_nodes, b.total_events, b.total_new_nodes)
    for ea, eb in zip(a, b):
        assert (ea.t_start, ea.t_end, ea.node_base) == \
            (eb.t_start, eb.t_end, eb.node_base)
        for f in ("src", "dst", "node_feats", "node_labels"):
            x, y = getattr(ea, f), getattr(eb, f)
            if x is None:
                assert y is None
            else:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_drained_batch_is_immutable():
    buf = DeltaBuffer(4, 2)
    buf.add_edges([0], [1])
    batch = buf.drain()
    assert isinstance(batch, DeltaBatch)
    with pytest.raises(Exception):
        batch.node_base = 9


def test_buffer_under_contending_producers():
    """More producer threads than cores stage edges and nodes at once, with
    a short switch interval: seqs and new ids stay unique and contiguous,
    and one drain returns every op in seq order."""
    import sys
    import threading
    n_threads, per_thread, v = 16, 200, 10
    buf = DeltaBuffer(v, 2, max_pending=10 ** 6)
    seqs, ids, lock = [], [], threading.Lock()
    start = threading.Barrier(n_threads)

    def produce(k):
        start.wait(timeout=30)
        for j in range(per_thread):
            if j % 5 == 0:
                got = buf.add_nodes(np.full((2, 2), k, np.float32))
                with lock:
                    ids.extend(got.tolist())
            else:
                s = buf.add_edges([k % v, j % v], [(k + 1) % v, 0])
                with lock:
                    seqs.extend([s, s + 1])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=produce, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    n_edges = n_threads * per_thread * 4 // 5 * 2
    assert sorted(seqs) == list(range(n_edges))
    assert sorted(ids) == list(range(v, v + len(ids)))
    batch = buf.drain()
    assert batch.num_ops == n_edges and batch.num_new_nodes == len(ids)
    np.testing.assert_array_equal(batch.edge_seq, np.arange(n_edges))
    assert buf.pending() == 0 and buf.admitted == n_edges + len(ids)
