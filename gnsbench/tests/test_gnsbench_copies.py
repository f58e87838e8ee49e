"""The benchmark's frozen copies and its arithmetic against hand counts at
tiny sizes."""
import numpy as np
import pytest
import torch

from gnsbench import data, flops, reference, trace


def test_csr_from_edges_hand_count():
    # edges 0-1, 1-2, 2-0, a duplicate 1-0, a self loop 3-3, 3-1
    src = torch.tensor([0, 1, 2, 1, 3, 3])
    dst = torch.tensor([1, 2, 0, 0, 3, 1])
    indptr, indices = data.csr_from_edges(src, dst, 5)
    assert indptr.tolist() == [0, 2, 5, 7, 8, 8]
    assert indices.tolist() == [1, 2, 0, 2, 3, 0, 1, 1]
    assert indices.dtype == np.int32


def test_powerlaw_degrees_hand_count():
    # n 4, mean 2, alpha 2: raw = 1/u; the cap max(2, 40) does not bind
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(4, generator=gen, dtype=torch.float64)
    raw = 1.0 / u
    want = (raw * (2.0 / raw.mean())).long().clamp(min=1)
    got = data.powerlaw_degrees(4, 2.0, 2.0, torch.Generator().manual_seed(0))
    assert got.tolist() == want.tolist()
    deg = data.powerlaw_degrees(10_000, 8.0, 2.1,
                                torch.Generator().manual_seed(0))
    assert int(deg.min()) >= 1 and abs(float(deg.float().mean()) - 8.0) < 1.0


def test_sbm_graph_is_undirected_simple_and_seeded():
    a = data.sbm_graph(500, 4, 6.0, 0.8, 2.1, seed=5, device="cpu")
    b = data.sbm_graph(500, 4, 6.0, 0.8, 2.1, seed=5, device="cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    indptr, indices, labels = a
    rows = np.repeat(np.arange(500), np.diff(indptr))
    pairs = set(zip(rows.tolist(), indices.tolist()))
    assert all((v, u) in pairs for u, v in pairs)          # symmetric
    assert all(u != v for u, v in pairs)                   # no loops
    assert len(pairs) == len(indices)                      # no duplicates
    for v in range(500):                                   # rows ascending
        nb = indices[indptr[v]:indptr[v + 1]]
        assert (np.diff(nb) > 0).all()
    assert set(labels.tolist()) <= set(range(4))
    # most edges stay inside a block (p_in 0.8 rewires cross pairs)
    assert (labels[rows] == labels[indices]).mean() > 0.6
    # about avg_degree stubs a node, each an edge end: mean degree near 6
    assert 4.0 < len(indices) / 500 < 7.0


def test_split_sizes_and_disjointness():
    tr, va, te = data.split(1000, 0.1, 0.02, seed=1)
    assert (len(tr), len(va), len(te)) == (100, 20, 880)
    assert len(np.intersect1d(tr, va)) == len(np.intersect1d(tr, te)) == 0


def test_features_are_prototypes_plus_noise():
    labels = np.array([0, 1, 1, 2, 0], dtype=np.int32)
    x = data.make_features(labels, 3, 4, 0.0, seed=2, device="cpu")
    assert x.shape == (5, 4) and x.dtype == np.float32
    assert np.array_equal(x[0], x[4]) and np.array_equal(x[1], x[2])
    y = data.make_features(labels, 3, 4, 1.5, seed=2, device="cpu")
    assert not np.array_equal(y[0], y[4])


def test_bound_ms_takes_the_larger_term():
    ms, by = flops.bound_ms(3.35e9, 1)           # 3.35 GB: 1 ms of HBM
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = flops.bound_ms(1, 67e9)             # 67 GFLOP: 1 ms of f32
    assert by == "operations" and ms == pytest.approx(1.0)


def test_sample_work_hand_count():
    # bsz 4, k 2, 1 uncached dst, CSR of 3 rows and 5 entries, 2 distinct
    # rows read by 3 live lanes, d 8
    n_bytes, n_flops = flops.sample_work(4, 2, 1, 3, 5, 2, 3, 8)
    assert n_bytes == 4 * 4 + 1 * 2 * 8 + (3 + 1 + 5) * 4 + 3 * 8 \
        + 2 * 8 * 4 + 4 * 8 * 4
    assert n_flops == 2 * 3 * 8


def test_sage_step_flops_hand_count():
    # two layers: 10 rows fanout 2 width 4 -> 3, then 2 rows fanout 3 3 -> 5
    got = flops.sage_step_flops([10, 2], [2, 3], [4, 3, 5])
    layer0 = 2 * 10 * 2 * 4 + 2 * (2 * 10 * 8 * 3)
    layer1 = 2 * (2 * 2 * 3 * 3) + 3 * (2 * 2 * 6 * 5)
    assert got == layer0 + layer1


def _fmix(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_lane_bits_match_a_scalar_chain():
    rows, lanes = np.arange(3)[:, None], np.arange(4)[None, :]
    got = reference.lane_bits(0xDEADBEEF, 7, rows, lanes)
    for r in range(3):
        for j in range(4):
            h = 0x9E3779B9
            for w in (0xDEADBEEF, 7, r, j):
                h = _fmix(h ^ w)
            assert int(got[r, j]) == h


def test_is_neighbor_and_ragged():
    indptr = np.array([0, 2, 3, 3, 5])
    indices = np.array([1, 3, 0, 0, 1], dtype=np.int32)
    v = np.array([0, 0, 0, 1, 2, 3, 3])
    u = np.array([1, 2, 3, 0, 0, 1, 2])
    assert reference.is_neighbor(indptr, indices, v, u).tolist() == \
        [True, False, True, True, False, True, False]
    row, nbr, lens = reference.ragged(indptr, indices, np.array([3, 0]))
    assert row.tolist() == [0, 0, 1, 1] and nbr.tolist() == [0, 1, 1, 3]


def test_cache_probs_hand_count():
    # path 0 - 1 - 2; train on node 0; one walk step of fanout 1
    indptr = np.array([0, 1, 3, 4])
    indices = np.array([1, 0, 2, 1], dtype=np.int32)
    p = reference.cache_probs(indptr, indices, np.array([0]), "random_walk",
                              walk_fanouts=(1,))
    # P = [1, 0, 0] + node 0 pushes 1 * min(1/1, 1) onto node 1
    assert p.tolist() == pytest.approx([0.5, 0.5, 0.0])
    d = reference.cache_probs(indptr, indices, None, "degree")
    assert d.tolist() == pytest.approx([0.25, 0.5, 0.25])


def test_inclusion_lambda_sums_to_the_cache_size():
    p = np.array([0.5, 0.25, 0.125, 0.125])
    lam = reference.inclusion_lambda(p, 2)
    assert -np.expm1(-lam * p).sum() == pytest.approx(2.0, rel=1e-10)
    assert reference.inclusion_lambda(p, 4) is None


def test_draw_z_hand_count():
    # node 0 has no probability; nodes 1-8 p^C 0.5 each: two bins of four
    # nodes, 2 members expected in each, variance 4 * 0.25 = 1
    probs = np.array([0.0] + [0.125] * 8)
    pc = np.array([0.0] + [0.5] * 8)
    assert reference.draw_z(probs, pc, np.array([1, 2, 5, 6]),
                            bins=2) == 0.0
    assert reference.draw_z(probs, pc, np.array([1, 2, 3, 5]),
                            bins=2) == 1.0
    assert reference.draw_z(probs, pc, np.array([1, 2, 3, 4]),
                            bins=2) == 2.0
    # bins follow rising p^C, not the node order
    pc2 = np.array([0.0] + [0.5] * 4 + [0.25] * 4)
    probs2 = np.array([0.0] + [0.2] * 4 + [0.05] * 4)
    # p^C sums to 3: bin 0 holds nodes 5-8 and node 1 (1.5 expected,
    # variance 4 * 0.1875 + 0.25 = 1), bin 1 nodes 2-4 (1.5, variance 0.75,
    # taken as 1); members 2-4 fill bin 1
    got = reference.draw_z(probs2, pc2, np.array([2, 3, 4]), bins=2)
    assert got == pytest.approx(1.5)
    got = reference.draw_z(probs2, pc2, np.array([5, 6, 7]), bins=2)
    assert got == pytest.approx(1.5)


def test_judge_reads_no_draw_when_every_node_is_cached():
    indptr = np.array([0, 1, 3, 4])
    indices = np.array([1, 0, 2, 1], dtype=np.int32)
    probs = np.array([0.25, 0.5, 0.25])
    judge = reference.Judge(indptr, indices, probs, np.arange(3), 3)
    assert judge.bad == 0 and judge.draw_z == 0.0


def test_adamw_first_step_moves_by_lr():
    p = [torch.tensor([1.0, -2.0])]
    g = [torch.tensor([0.5, -3.0])]
    st = {"t": 0, "m": [torch.zeros(2)], "v": [torch.zeros(2)]}
    reference.adamw(p, g, st, lr=0.1)
    assert p[0].tolist() == pytest.approx([0.9, -1.9], rel=1e-6)
    assert st["m"][0].tolist() == pytest.approx([0.05, -0.3])


class _Ev:
    def __init__(self, name, s, e, dev=False, tid=1):
        self._n, self._s, self._d = name, s, e - s
        self._dev, self._t = dev, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_thread_id(self):
        return self._t


def test_trace_union_gaps_and_labels():
    evs = [_Ev(trace.WINDOW_SPAN, 0, 100),
           _Ev("gnsbench.next_batch", 0, 40),
           _Ev("gnsbench.run_batch", 40, 100),
           _Ev("aten::copy_", 45, 60),
           _Ev("k1", 10, 30, dev=True), _Ev("k2", 20, 35, dev=True),
           _Ev("k1", 70, 90, dev=True), _Ev("other", 50, 55, tid=2),
           _Ev("gnsbench.run_batch", 40, 100, dev=True)]
    s = trace.summarize(evs)
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(45e-9)             # [10,35] + [70,90]
    assert s.gaps == [(35, 70), (0, 10), (90, 100)]
    # quarters at 39.375, 48.125, 56.875, 65.625 of the gap (35, 70)
    assert s.idle["gnsbench.next_batch"] == pytest.approx(8.75e-9 + 10e-9)
    assert s.idle["gnsbench.run_batch/aten::copy_"] == pytest.approx(
        17.5e-9)
    assert s.idle["gnsbench.run_batch"] == pytest.approx(8.75e-9 + 10e-9)
    assert s.kernel("k1") == (pytest.approx(40e-9), 2)
    bd = trace.breakdown(s)
    assert bd["device_ops"][0][0] == "k1"
