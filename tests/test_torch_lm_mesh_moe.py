"""The MoE family trained on a mesh of ranks (expert parallelism over
``model``, ZeRO-3 over ``data``), against the reference's
``train_loop(mesh=)``; one MoE layer on a mesh against one device; and
attention whose heads do not divide the model axis.

As ``tests/test_torch_lm_mesh.py``: gloo ranks on the CPU, one spawn per
mesh shape, and the reference's own runs on 4 forced host devices in one
background subprocess, from the reference's parameters; 2 steps at batch
4 x 32 in f32, lr 1e-3.  deepseek-v2-236b (MLA) and arctic-480b run with
``fsdp=True``, as their published configs do.

What the reference does, and so what is held here:

* model > 1: each expert's capacity is chosen over a data shard's T_loc
  tokens (a local ``top_k``), so at (2, 2) the losses differ from the run
  without a mesh (by design) and are held to the reference's alone; at
  (1, 2) and (1, 4) T_loc is the whole batch;
* model = 1, data > 1: the reference's single-device branch routes over
  the global batch: the (2, 1) losses equal the run without a mesh;
* a model axis of 3, which divides neither the reduced configs' 4
  experts nor their 4 heads: the reference's single-device branch under
  GSPMD, held on (1, 3) (the reference's mesh over 3 of the 4 forced host
  devices, in the same background subprocess) with the expert stacks
  replicated (f = 32, deepseek and arctic) or split along their hidden
  dim (deepseek with ``d_expert=48``), and deepseek's MLA over all heads
  on every rank (``q_up`` a column block gathered whole, ``wo`` whole, or
  a row block with ``v_head=24``).  With data = 1 the local token count
  is the whole batch, so these losses also equal the run without a mesh.

Tolerances: losses rtol 1e-5 (f32); the MoE layer's output and gradients
against one device rtol 1e-5, atol 1e-6: expert parallelism sums each
rank's experts and then the ranks, another grouping of the same f32
terms, so it is not bit for bit (experts split along f: the router's
gradient with that atol taken of its largest element, see
``ROUTER_SPLIT_ATOL``).  The router's gradient, summed over the
model group, is the same on every rank bit for bit.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402

import _torch_lm_mesh_ranks as R  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SPAWN_S = 300
LOSS_RTOL = 1e-5
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
# the router's gradient on experts split along f, of its largest |element|:
# it sums over the tokens softmax-backward terms as large as that element,
# and each expert output it is taken against is a sum of 3 partial
# products, not one, so an element near 0 moves by ~1e-7 of the largest
ROUTER_SPLIT_ATOL = 1e-6
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4), (1, 3))
MOE = (("deepseek", "deepseek-v2-236b", {"fsdp": True}),
       ("arctic", "arctic-480b", {"fsdp": True}))
# 6 heads on a model axis of 4: q, K and V gathered, every rank attends
SPLIT_HEADS = (("qwen2-6heads", "qwen2-7b", {"num_heads": 6}),)
# on 3 model ranks: experts whole (f = 32) or split along f (48 = 3 x 16);
# MLA's wo [H·v_head, d] whole (4 x 16) or a row block (4 x 24 = 3 x 32)
HIDDEN = (("deepseek-d48", "deepseek-v2-236b",
           {"fsdp": True, "moe": {"d_expert": 48}}),
          ("deepseek-wo-rows", "deepseek-v2-236b",
           {"fsdp": True, "mla": {"v_head": 24}}))
THREE = MOE[:1] + HIDDEN + MOE[1:]
# MLA layers on (1, 3), (kind, heads, seed): 4 heads, wo whole / row block
MLA_CASES = (("mla", 4, 11), ("mla-rows", 4, 12))
MLA_TOL = 1e-5    # of each leaf's largest |value|, as tests/test_torch_lm_
                  # mesh_tp.py holds its layers


def _cells(mesh):
    if mesh == (1, 4):
        return MOE[:1] + SPLIT_HEADS
    if mesh == (1, 3):
        return THREE
    return MOE


ALL = [(name, mesh) for mesh in MESHES for name, _, _ in _cells(mesh)]
LAYER_MESHES = MESHES[:3]


def _ref_params(arch, kw):
    cfg = R.with_kw(jconfigs.get_config(arch).reduced(), kw)
    return jax.tree_util.tree_map(np.asarray, jget_model(cfg).init(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params():
    return {n: _ref_params(a, kw) for n, a, kw in MOE + SPLIT_HEADS + HIDDEN}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    sys.path.insert(0, str(Path(__file__).parent))
    from test_torch_lm_mesh import Reference, ref_cell
    cells = [ref_cell(f"{n}@{m}", a, kw, m) for m in MESHES
             for n, a, kw in _cells(m)]
    return Reference(tmp_path_factory.mktemp("lm_mesh_moe_ref"), cells)


def _layer_case(**moe_kw):
    """A reduced deepseek MoE layer (shared expert; capacity factor 0.5,
    so experts drop tokens; ``moe_kw`` more MoECfg changes), x [4, 16, d]
    and the output weights."""
    kw = {"moe": {"capacity_factor": 0.5, **moe_kw}}
    jcfg, cfg = (R.with_kw(jconfigs.get_config("deepseek-v2-236b").reduced(),
                           kw), R.cfg_of("deepseek-v2-236b", kw))
    p = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    return cfg, p, x, w


@pytest.fixture(scope="module")
def layer_case():
    return _layer_case()


@pytest.fixture(scope="module")
def layer_case_hidden():
    """The layer with ``d_expert=48``: split along f on 3 model ranks."""
    return _layer_case(d_expert=48)


@pytest.fixture(scope="module")
def ranks(params, reference, layer_case, layer_case_hidden):
    out = {}
    for d, m in MESHES:
        args = (list(_cells((d, m))), params)
        if m == 3:
            out[(d, m)] = run_ranks(
                "_torch_lm_mesh_ranks:three_ranks", data=d, model=m,
                devices=["cpu"] * (d * m), backend="gloo", timeout_s=SPAWN_S,
                args=args + (layer_case, layer_case_hidden, list(MLA_CASES)))
        elif (d, m) in LAYER_MESHES:
            out[(d, m)] = run_ranks(
                "_torch_lm_mesh_ranks:moe_mesh_ranks", data=d, model=m,
                devices=["cpu"] * (d * m), backend="gloo", timeout_s=SPAWN_S,
                args=args + (layer_case,))
        else:
            out[(d, m)] = [{"train": r} for r in run_ranks(
                "_torch_lm_mesh_ranks:train_ranks", data=d, model=m,
                devices=["cpu"] * (d * m), backend="gloo", timeout_s=SPAWN_S,
                args=args)]
    return out


@pytest.fixture(scope="module")
def single(params):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {n: R.train(R.cfg_of(a, kw), params[n], None, "cpu")
                for n, a, kw in MOE + SPLIT_HEADS + HIDDEN}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name,mesh", ALL)
def test_losses_match_reference_on_the_same_mesh(ranks, reference, name,
                                                  mesh):
    want = reference.losses()[f"{name}@{mesh}"]
    got = [r["train"][name][0] for r in ranks[mesh]]
    for g in got:
        assert g == got[0]
    np.testing.assert_allclose(got[0], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name,mesh", ALL)
def test_capacity_follows_the_reference(ranks, reference, single, name,
                                        mesh):
    """Per-shard capacity at (2, 2) moves the losses off the run without
    a mesh, in the reference and in the port alike; every other mesh
    keeps them (the global batch at (2, 1), T_loc = T at (1, m)).  The
    port's run without a mesh stands for the reference's (held to it
    within 1e-5 by ``tests/test_torch_moe_lm.py``)."""
    got = ranks[mesh][0]["train"][name][0]
    if mesh == (2, 2):
        ref = reference.losses()[f"{name}@{mesh}"]
        assert not np.allclose(ref, single[name][0], rtol=1e-6)
        assert not np.allclose(got, single[name][0], rtol=1e-6)
    else:
        np.testing.assert_allclose(got, single[name][0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name,mesh", [c for c in ALL if c[1][1] > 1])
def test_replicated_blocks_equal_across_ranks(ranks, single, name, mesh):
    """A leaf's block is the same bit for bit on every rank that its plan
    does not split it over: across the model group where the leaf is not
    sharded over ``model`` (norms, the router: its gradient is summed over
    the model group before the update), across the data group where it is
    not sharded over ``data``.  (At (2, 1) ZeRO-3 splits every leaf.)"""
    import types
    from test_torch_lm_mesh import _flat
    from repro_torch.launch.sharding import tree_param_shardings
    d, m = mesh
    duck = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d, "model": m})
    plans = _flat(tree_param_shardings(duck, single[name][1], fsdp=True))
    local = [_flat(r["train"][name][1]) for r in ranks[mesh]]
    checked = 0
    for path, plan in plans.items():
        for axis, peers in (("model", lambda r: r - r % m),
                            ("data", lambda r: r % m)):
            if axis in plan.axes or duck.shape[axis] == 1:
                continue
            for r, block in enumerate(local):
                assert np.array_equal(block[path], local[peers(r)][path]), \
                    (path, axis, r)
                checked += 1
    assert checked


def _one_device(cfg, p, x, w):
    tp = params_from_numpy(p, device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()
              if isinstance(v, torch.Tensor)}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_forward({**tp, **leaves}, cfg, xt)
    names = sorted(leaves)
    g = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                            [leaves[k] for k in names] + [xt])
    return out.detach().numpy(), dict(zip(names + ["x"],
                                          (t.numpy() for t in g)))


@pytest.mark.parametrize("mesh", LAYER_MESHES)
def test_moe_layer_on_a_mesh(ranks, layer_case, mesh):
    """Expert parallel at (1, 2) against one device; the global batch at
    (2, 1) against one device (each rank's rows; the data ranks'
    weight gradients sum to one device's); at (2, 2) each data shard
    against one device on its own rows (capacity over T_loc).  Expert
    stacks are blocks by rank; the router's gradient equal on every model
    rank bit for bit."""
    cfg, p, x, w = layer_case
    d, m = mesh
    got = [r["layer"] for r in ranks[mesh]]
    n = x.shape[0] // d
    shards = [_one_device(cfg, p, x[i * n:(i + 1) * n], w[i * n:(i + 1) * n])
              for i in range(d)] if m > 1 else None
    whole = _one_device(cfg, p, x, w)
    for di in range(d):
        want_out, want_g = (shards[di] if m > 1 else
                            (whole[0][di * n:(di + 1) * n], whole[1]))
        row = got[di * m:(di + 1) * m]
        for r in row:
            np.testing.assert_allclose(r["out"], want_out, **LAYER_TOL)
            assert np.array_equal(r["grads"]["router"],
                                  row[0]["grads"]["router"])
        if m > 1:
            np.testing.assert_allclose(row[0]["grads"]["router"],
                                       want_g["router"], **LAYER_TOL)
            np.testing.assert_allclose(row[0]["grads"]["x"], want_g["x"],
                                       **LAYER_TOL)
            for k in ("experts_w1", "experts_w2", "experts_w3"):
                np.testing.assert_allclose(
                    np.concatenate([r["grads"][k] for r in row]),
                    want_g[k], **LAYER_TOL)
        else:
            np.testing.assert_allclose(
                row[0]["grads"]["x"],
                whole[1]["x"][di * n:(di + 1) * n], **LAYER_TOL)
    if m == 1:
        for k in ("router", "experts_w1", "experts_w2", "experts_w3"):
            np.testing.assert_allclose(sum(r["grads"][k] for r in got),
                                       whole[1][k], **LAYER_TOL)


def _grads_of_blocks(row: list, k: str, full_shape: tuple) -> np.ndarray:
    """The full gradient of an expert stack from the model ranks' blocks:
    each rank's whole when it holds the leaf whole, else the blocks
    concatenated along the dim they split."""
    blocks = [r["grads"][k] for r in row]
    if blocks[0].shape == full_shape:
        for b in blocks[1:]:
            assert np.array_equal(b, blocks[0]), k
        return blocks[0]
    dim = [i for i, (a, b) in enumerate(zip(blocks[0].shape, full_shape))
           if a != b]
    assert len(dim) == 1, (k, blocks[0].shape, full_shape)
    return np.concatenate(blocks, axis=dim[0])


@pytest.mark.parametrize("which", ["whole", "hidden"])
def test_moe_layer_on_three_model_ranks(ranks, layer_case, layer_case_hidden,
                                        which):
    """(1, 3): the single-device branch on every rank.  Experts whole
    (f = 32): every rank computes the layer of one device, no sum.  Split
    along f (48): each rank's partial output summed over the model group.
    Either way every rank's output, the router's gradient (the same bit
    for bit on every rank), the input's and the expert stacks' (the
    blocks put together) are one device's within ``LAYER_TOL``; split
    along f, the router's gradient with ``LAYER_TOL``'s atol taken of its
    largest element (``ROUTER_SPLIT_ATOL``)."""
    case = layer_case if which == "whole" else layer_case_hidden
    cfg, p, x, w = case
    row = [r["layer" if which == "whole" else "hidden"]
           for r in ranks[(1, 3)]]
    want_out, want_g = _one_device(cfg, p, x, w)
    for r in row:
        np.testing.assert_allclose(r["out"], want_out, **LAYER_TOL)
        assert np.array_equal(r["grads"]["router"], row[0]["grads"]["router"])
    np.testing.assert_allclose(row[0]["grads"]["x"], want_g["x"],
                               **LAYER_TOL)
    router = dict(LAYER_TOL)
    if which == "hidden":
        router["atol"] = ROUTER_SPLIT_ATOL * np.abs(want_g["router"]).max()
    np.testing.assert_allclose(row[0]["grads"]["router"], want_g["router"],
                               **router)
    for k in ("experts_w1", "experts_w2", "experts_w3"):
        got = _grads_of_blocks(row, k, want_g[k].shape)
        np.testing.assert_allclose(got, want_g[k], **LAYER_TOL)
    split = row[0]["grads"]["experts_w1"].shape != want_g["experts_w1"].shape
    assert split == (which == "hidden")


@pytest.mark.parametrize("name", [n for n, _, _ in THREE])
def test_local_expert_shapes_follow_the_rule_table(ranks, single, name):
    """On (1, 3) the experts lose ``expert`` on E (4 does not divide 3)
    and take ``model`` on f where f divides: w1/w3 [E, d, f/3] and w2
    [E, f/3, d] at f = 48, whole at f = 32: every rank holds such a
    block after training."""
    from test_torch_lm_mesh import _flat
    full = _flat(single[name][1])
    cfg = R.cfg_of(*[(a, kw) for n, a, kw in THREE if n == name][0])
    f = cfg.moe.d_expert
    paths = [k for k in full if k.split("/")[-1].startswith("experts_w")]
    assert paths
    for path in paths:
        shape = full[path].shape
        want = list(shape)
        if f % 3 == 0:
            want[-1 if path.endswith(("w1", "w3")) else -2] = f // 3
        for r in ranks[(1, 3)]:
            assert _flat(r["train"][name][1])[path].shape == tuple(want), \
                (name, path)


@pytest.mark.parametrize("case", [f"{k}/{h}" for k, h, _ in MLA_CASES])
def test_mla_layer_on_three_model_ranks(ranks, case):
    """MLA with 4 heads on 3 model ranks: every rank attends over all
    heads, ``q_up`` a column block gathered whole and ``k_up`` whole; the
    output and every gradient (this rank's block of a split leaf) are one
    device's within ``MLA_TOL``.  ``wo`` is whole (no sum over the group:
    every rank's gradients are the whole ones) or, with ``v_head`` 24, a
    row block (each rank's block of the output into it, summed)."""
    results = [r["attn"][case] for r in ranks[(1, 3)]]
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
        if k not in split:                      # whole leaves and inputs
            for res in results[1:]:
                assert np.array_equal(res["mesh"][1][k], g0), k
