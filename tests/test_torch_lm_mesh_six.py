"""The MoE family on a (data, model) = (2, 3) mesh: data > 1 beside a model
axis that divides neither the reduced configs' 4 experts nor their 4
heads, against the reference's ``train_loop(mesh=)`` on the same mesh and
without one; one MoE layer and one MLA layer on the mesh against one
device.

A file of its own (its own spawn, and the reference's runs on 6 forced
host devices in one background subprocess, ``tests/_lm_mesh_reference.py``)
so that ``--dist loadfile`` puts it on a worker apart from
``tests/test_torch_lm_mesh_moe.py``, which holds the same branches on
(2, 1) and (1, 3).  Cells, steps and tolerances are that file's: the four
``THREE`` cells (deepseek with experts whole at f = 32, split along f at
``d_expert`` 48, MLA's ``wo`` a row block at ``v_head`` 24, and arctic
beside its dense residual), each with ``fsdp=True``, 2 steps at batch
4 x 32 in f32, lr 1e-3.

What (2, 3) runs that neither (2, 1) nor (1, 3) does: the reference's
single-device branch under GSPMD routes the global batch (a ``top_k`` over
all T tokens), so the port gathers the token rows over the data group,
splits the experts along f over the model group (or computes them whole on
every model rank), sums the partial outputs over the model group, and
slices its rows back; backward, the gathered rows' gradient is summed over
the model group (``copy_to``) and over the data group (the gather), once
each, then sliced.  ZeRO-3 also splits a dim of every leaf over
``data``.

Tolerances: losses rtol 1e-5 (against the reference on (2, 3) and
without a mesh: global-batch routing makes the two equal); the MoE layer
``LAYER_TOL`` against one device on the whole batch (the router's
gradient, experts split along f, with ``ROUTER_SPLIT_ATOL`` of its largest
element); the MLA layer ``MLA_TOL`` of each leaf's largest value.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.sharding import tree_param_shardings  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402

import _torch_lm_mesh_ranks as R  # noqa: E402
from test_torch_lm_mesh import Reference, _flat, ref_cell  # noqa: E402
from test_torch_lm_mesh_moe import (LAYER_TOL, LOSS_RTOL,  # noqa: E402
                                    MLA_CASES, MLA_TOL, ROUTER_SPLIT_ATOL,
                                    SPAWN_S, THREE, _grads_of_blocks,
                                    _layer_case, _one_device, _ref_params)

MESH = (2, 3)
NAMES = [n for n, _, _ in THREE]


@pytest.fixture(scope="module")
def params():
    return {n: _ref_params(a, kw) for n, a, kw in THREE}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cells = [ref_cell(f"{n}@{m}", a, kw, m) for m in (MESH, None)
             for n, a, kw in THREE]
    return Reference(tmp_path_factory.mktemp("lm_mesh_six_ref"), cells,
                     devices=MESH[0] * MESH[1])


@pytest.fixture(scope="module")
def layer_case():
    return _layer_case()


@pytest.fixture(scope="module")
def layer_case_hidden():
    return _layer_case(d_expert=48)


@pytest.fixture(scope="module")
def ranks(params, reference, layer_case, layer_case_hidden):
    """Every rank's results, rank r = data·3 + model (the ranks run while
    the reference does)."""
    d, m = MESH
    return run_ranks("_torch_lm_mesh_ranks:three_ranks", data=d, model=m,
                     devices=["cpu"] * (d * m), backend="gloo",
                     timeout_s=SPAWN_S,
                     args=(list(THREE), params, layer_case,
                           layer_case_hidden, list(MLA_CASES)))


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_reference_on_the_same_mesh(ranks, reference, name):
    got = [r["train"][name][0] for r in ranks]
    for g in got:                        # every rank reports the same loss
        assert g == got[0]
    np.testing.assert_allclose(got[0], reference.losses()[f"{name}@{MESH}"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_the_reference_without_a_mesh(ranks, reference, name):
    """Global-batch routing: the reference's (2, 3) run and its run
    without a mesh route alike, and so does the port's (2, 3) run."""
    want = reference.losses()
    np.testing.assert_allclose(want[f"{name}@{MESH}"], want[f"{name}@None"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["train"][name][0],
                               want[f"{name}@None"], rtol=LOSS_RTOL)


def _plans(params, name):
    d, m = MESH
    duck = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d, "model": m})
    full = _flat(params_from_numpy(params[name], device="cpu"))
    return full, _flat(tree_param_shardings(duck, full, fsdp=True))


@pytest.mark.parametrize("name", NAMES)
def test_replicated_blocks_equal_across_ranks(ranks, params, name):
    """A leaf's block is the same bit for bit on every rank of a model
    group where its plan does not split it over ``model`` (norms, the
    router, experts whole at f = 32: the router's gradient is summed over
    the model group before the update).  ZeRO-3 splits every leaf of
    these configs over ``data`` (each has a dim that 2 divides), so no
    block is shared across the data group."""
    d, m = MESH
    _, plans = _plans(params, name)
    assert all("data" in plan.axes for plan in plans.values())
    local = [_flat(r["train"][name][1]) for r in ranks]
    checked = 0
    for path, plan in plans.items():
        if "model" in plan.axes:
            continue
        for r, block in enumerate(local):
            assert np.array_equal(block[path], local[r - r % m][path]), \
                (path, r)
            checked += 1
    assert checked


@pytest.mark.parametrize("name", NAMES)
def test_local_expert_shapes_follow_the_rule_table(ranks, params, name):
    """E stays whole (4 does not divide 3), f takes ``model`` where it
    divides (w1/w3 [.., E, d, f/3], w2 [.., E, f/3, d] at f = 48) and
    ZeRO-3 halves the largest dim left whole that 2 divides: every rank
    holds such a block after training."""
    full, plans = _plans(params, name)
    cfg = R.cfg_of(*[(a, kw) for n, a, kw in THREE if n == name][0])
    e, f = cfg.moe.num_experts, cfg.moe.d_expert
    paths = [k for k in full if k.split("/")[-1].startswith("experts_w")]
    assert paths
    for path in paths:
        shape = tuple(full[path].shape)
        want = list(shape)
        f_dim = len(shape) - (1 if path.endswith(("w1", "w3")) else 2)
        assert shape[f_dim] == f and shape[-3] == e
        if f % 3 == 0:
            want[f_dim] = f // 3
        free = [i for i in range(len(want))
                if not (i == f_dim and f % 3 == 0) and want[i] % 2 == 0]
        want[max(free, key=lambda i: (want[i], -i))] //= 2
        assert tuple(want) == plans[path].local_shape, path
        for r in ranks:
            assert _flat(r["train"][name][1])[path].shape == tuple(want), \
                (name, path)


@pytest.mark.parametrize("which", ["whole", "hidden"])
def test_moe_layer_on_six_ranks(ranks, layer_case, layer_case_hidden,
                                which):
    """One MoE layer forward and backward, data rank di on rows
    [2·di, 2·di + 2) of x [4, 16, d], against one device on the whole
    batch: each rank's output is one device's rows; the router's gradient
    is the same bit for bit on every rank of a model group, and the data
    ranks' gradients of the router and of each expert stack (the model
    ranks' blocks put together) sum to one device's; each rank's
    gradient of x is one device's rows."""
    cfg, p, x, w = layer_case if which == "whole" else layer_case_hidden
    key = "layer" if which == "whole" else "hidden"
    d, m = MESH
    n = x.shape[0] // d
    want_out, want_g = _one_device(cfg, p, x, w)
    router_tol = dict(LAYER_TOL)
    if which == "hidden":
        router_tol["atol"] = (ROUTER_SPLIT_ATOL
                              * np.abs(want_g["router"]).max())
    rows = [[r[key] for r in ranks[di * m:(di + 1) * m]] for di in range(d)]
    sums = {}
    for di, row in enumerate(rows):
        mine = slice(di * n, (di + 1) * n)
        for r in row:
            np.testing.assert_allclose(r["out"], want_out[mine], **LAYER_TOL)
            assert np.array_equal(r["grads"]["router"],
                                  row[0]["grads"]["router"])
            np.testing.assert_allclose(r["grads"]["x"], want_g["x"][mine],
                                       **LAYER_TOL)
        sums["router"] = sums.get("router", 0) + row[0]["grads"]["router"]
        for k in ("experts_w1", "experts_w2", "experts_w3"):
            sums[k] = sums.get(k, 0) + _grads_of_blocks(row, k,
                                                        want_g[k].shape)
    np.testing.assert_allclose(sums["router"], want_g["router"],
                               **router_tol)
    for k in ("experts_w1", "experts_w2", "experts_w3"):
        np.testing.assert_allclose(sums[k], want_g[k], **LAYER_TOL)
    split = (rows[0][0]["grads"]["experts_w1"].shape
             != want_g["experts_w1"].shape)
    assert split == (which == "hidden")


def _kept_on_one_device(cfg, p, x):
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    top_aff, top_idx = moe.route(xt, torch.tensor(p["router"]), cfg,
                                 cfg.moe.num_experts, 0)
    return R.kept_pairs(top_aff, top_idx)


def test_routing_drops_the_choices_of_one_device(ranks, layer_case):
    """Capacity over T versus T_loc = T/2: the layer case (capacity factor
    0.5) keeps other (token, expert) choices when each data shard is
    routed alone than when the whole batch is, so the two tell global
    routing from local.  On (2, 3) every rank keeps exactly one device's
    choices over the whole batch, and its output is one device's rows,
    not the output of its shard routed alone."""
    cfg, p, x, w = layer_case
    d, m = MESH
    n = x.shape[0] // d
    tokens = x.shape[0] * x.shape[1] // d
    whole = _kept_on_one_device(cfg, p, x)
    local = np.concatenate([
        _kept_on_one_device(cfg, p, x[i * n:(i + 1) * n])
        + np.array([i * tokens, 0]) for i in range(d)])
    local = local[np.lexsort((local[:, 1], local[:, 0]))]
    assert not np.array_equal(whole, local)
    want_out = _one_device(cfg, p, x, w)[0]
    for rank, r in enumerate(ranks):
        di = rank // m
        np.testing.assert_array_equal(r["layer"]["kept"], whole)
        shard = _one_device(cfg, p, x[di * n:(di + 1) * n],
                            w[di * n:(di + 1) * n])[0]
        got = r["layer"]["out"]
        np.testing.assert_allclose(got, want_out[di * n:(di + 1) * n],
                                   **LAYER_TOL)
        assert not np.allclose(got, shard, **LAYER_TOL)


@pytest.mark.parametrize("case", [f"{k}/{h}" for k, h, _ in MLA_CASES])
def test_mla_layer_on_six_ranks(ranks, case):
    """MLA with 4 heads on (2, 3): every rank attends over all heads
    (``q_up`` a column block gathered whole, ``k_up`` whole; ``wo`` whole,
    or a row block at ``v_head`` 24), its data rank's copy of the batch
    alike; the output and every gradient (this rank's block of a split
    leaf) are one device's within ``MLA_TOL``, and the whole leaves' and
    inputs' gradients are the same bit for bit on every rank."""
    results = [r["attn"][case] for r in ranks]
    split = set(results[0]["split"])
    assert {"q_up"} <= split and "k_up" not in split
    assert ("wo" in split) == case.startswith("mla-rows")
    for res in results:
        (one_out, one_g), (out, g) = res["one"], res["mesh"]
        np.testing.assert_allclose(out, one_out, rtol=0,
                                   atol=MLA_TOL * np.abs(one_out).max())
        assert sorted(g) == sorted(one_g)
        for k, want in one_g.items():
            np.testing.assert_allclose(
                g[k], want, rtol=0, atol=MLA_TOL * np.abs(want).max(),
                err_msg=k)
    for k, g0 in results[0]["mesh"][1].items():
        if k not in split:
            for res in results[1:]:
                assert np.array_equal(res["mesh"][1][k], g0), k
    # no collective crosses the data group: the layer is the same program
    # on both data ranks
    assert results[0]["collectives"] == results[MESH[1]]["collectives"]

