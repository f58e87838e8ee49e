"""Port parity: graph layer and §3.4 importance coefficients.

``repro_torch.graph`` and ``repro_torch.core.importance`` are copies of the
reference's numpy modules; under the same seeds they must give identical
arrays, bit for bit.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import importance as imp_ref  # noqa: E402
from repro.graph import csr as csr_ref  # noqa: E402
from repro.graph.datasets import get_dataset as get_ref  # noqa: E402
from repro_torch.core import importance as imp_port  # noqa: E402
from repro_torch.graph import csr as csr_port  # noqa: E402
from repro_torch.graph.datasets import get_dataset as get_port  # noqa: E402


@pytest.mark.parametrize("name,scale,seed", [("tiny", 1.0, 0),
                                             ("tiny", 1.0, 3),
                                             ("ogbn-products", 0.05, 1)])
def test_get_dataset_identical(name, scale, seed):
    a, b = get_ref(name, scale, seed), get_port(name, scale, seed)
    np.testing.assert_array_equal(a.graph.indptr, b.graph.indptr)
    np.testing.assert_array_equal(a.graph.indices, b.graph.indices)
    assert a.graph.indices.dtype == b.graph.indices.dtype
    for f in ("features", "labels", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("k", [3, 40])
def test_sample_neighbors_identical(k):
    g = get_port("tiny", 1.0, 0).graph
    g_ref = csr_ref.CSRGraph(indptr=g.indptr, indices=g.indices)
    nodes = np.random.default_rng(5).integers(0, g.num_nodes, 200)
    a = g_ref.sample_neighbors(nodes, k, np.random.default_rng(9))
    b = g.sample_neighbors(nodes, k, np.random.default_rng(9))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    mask = np.random.default_rng(2).random(g.num_nodes) < 0.1
    ca = g_ref.induced_cache_adjacency(mask)
    cb = g.induced_cache_adjacency(mask)
    np.testing.assert_array_equal(ca.indptr, cb.indptr)
    np.testing.assert_array_equal(ca.indices, cb.indices)
    assert isinstance(cb, csr_port.CacheAdjacency)


def test_importance_functions_identical():
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(500))
    for size in (5, 50):
        lam_a = imp_ref.solve_inclusion_lambda(p, size)
        lam_b = imp_port.solve_inclusion_lambda(p, size)
        assert lam_a == lam_b
        for lam in (None, lam_a):
            np.testing.assert_array_equal(
                imp_ref.cache_hit_prob(p, size, lam=lam),
                imp_port.cache_hit_prob(p, size, lam=lam))
        ncv = rng.integers(0, 12, (40, 1))
        for mode in ("ht", "paper"):
            np.testing.assert_array_equal(
                imp_ref.importance_coefficients(p[:40, None].repeat(4, 1),
                                                size, 4, ncv, mode=mode,
                                                lam=lam_a),
                imp_port.importance_coefficients(p[:40, None].repeat(4, 1),
                                                 size, 4, ncv, mode=mode,
                                                 lam=lam_a))
