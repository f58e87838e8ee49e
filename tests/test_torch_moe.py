"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) at reduced widths in f32, with the reference's own
parameters (``params_from_numpy``): ``init_moe``'s layout, the routing
(the sets of kept (token, expert) pairs), ``_routed_experts`` and
``moe_forward`` when experts drop tokens, when they take filler tokens,
at capacity 1, with shared experts and with a dense residual; the
deterministic combine against the reference's scatter-add and
``index_add_``; ``moe_aux_loss``; the
gradient of ``moe_forward`` against ``jax.grad``; and the routing of the
single-device branch on a model axis that does not divide the experts.

Tolerances: outputs and gradients rtol 1e-4, atol 1e-5 (the same f32
products, summed in other orders by XLA and by PyTorch's CPU kernels);
the combine bit for bit.  Routing is compared as
sets: ``torch.topk`` and ``jax.lax.top_k`` may order tied zero-affinity
filler tokens differently, and those carry weight 0.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.sharding import use_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import make_generator  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402
from repro_torch.models.scan_util import tree_leaves  # noqa: E402

DEEPSEEK, ARCTIC = "deepseek-v2-236b", "arctic-480b"
TOL = dict(rtol=1e-4, atol=1e-5)
# id -> (arch, MoECfg changes, tokens): drops at cf 0.5 (capacity 4 for
# 8 choices an expert on average), filler at cf 4 (capacity T), capacity 1
# at T = 2, and the default factor
ROUTING = {
    "oversubscribed": (DEEPSEEK, {"capacity_factor": 0.5}, 16),
    "undersubscribed": (DEEPSEEK, {"capacity_factor": 4.0}, 16),
    "capacity1": (DEEPSEEK, {}, 2),
    "default": (ARCTIC, {}, 32),
}


def _cfgs(arch, dtype="float32", **moe_kw):
    j, t = jconfigs.get_config(arch).reduced(), configs.get_config(
        arch).reduced()
    return tuple(dataclasses.replace(c, dtype=dtype, moe=dataclasses.replace(
        c.moe, **moe_kw)) for c in (j, t))


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_kept(xt, router, cfg) -> set:
    """The reference's routing (``moe.py:70-88``) of ``xt``: the (token,
    expert) pairs its capacity keeps with a non-zero gate weight."""
    m = cfg.moe
    t = xt.shape[0]
    probs = jax.nn.softmax(jnp.asarray(xt) @ router, axis=-1)
    gv, gi = jax.lax.top_k(probs, m.top_k)
    gv = gv / jnp.maximum(gv.sum(-1, keepdims=True), 1e-9)
    aff = jnp.zeros((t, m.num_experts)).at[jnp.arange(t)[:, None], gi].add(gv)
    cap = min(int(max(1, round(t * m.top_k / m.num_experts
                               * m.capacity_factor))), t)
    top_aff, top_idx = jax.lax.top_k(aff.T, cap)
    return {(int(top_idx[e, c]), e) for e in range(m.num_experts)
            for c in range(cap) if float(top_aff[e, c]) != 0.0}


def _kept(top_aff, top_idx) -> set:
    e, c = torch.nonzero(top_aff != 0, as_tuple=True)
    return {(int(top_idx[i, j]), int(i)) for i, j in zip(e, c)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [DEEPSEEK, ARCTIC])
def test_init_moe_matches_reference_layout(arch, dtype):
    """Keys, shapes and dtypes of the reference's ``init_moe`` (the router
    f32 in a bf16 model); the expert stacks have the reference's scale."""
    jcfg, tcfg = _cfgs(arch, dtype)
    want = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg),
                          jax.random.PRNGKey(0))
    got = moe.init_moe(make_generator(0, "cpu"), tcfg)
    assert set(got) == set(want)
    jl = jax.tree_util.tree_leaves(want)
    tl = tree_leaves(got)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tl] == \
        [(j.shape, str(j.dtype)) for j in jl]
    assert got["router"].dtype == torch.float32
    d, f = tcfg.d_model, tcfg.moe.d_expert
    for name, fan_in in (("experts_w1", d), ("experts_w2", f)):
        std = float(got[name].float().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, (name, std)


def test_expert_stacks_are_drawn_one_expert_at_a_time(monkeypatch):
    """No draw of ``init_moe`` covers a whole [E, d, f] stack: each expert
    is drawn as its own [d, f] matrix into the preallocated stack."""
    _, tcfg = _cfgs(ARCTIC)
    shapes = []
    randn = torch.randn

    def spy(*args, **kw):
        shapes.append(tuple(args[0]) if args and isinstance(
            args[0], (tuple, list)) else args)
        return randn(*args, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    p = moe.init_moe(make_generator(0, "cpu"), tcfg)
    e, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.moe.d_expert
    assert max(len(s) for s in shapes) == 2
    assert shapes.count((d, f)) >= 2 * e and shapes.count((f, d)) >= e
    assert p["experts_w1"].shape == (e, d, f)


@pytest.mark.parametrize("case", list(ROUTING))
def test_routed_experts_match_reference(case):
    """``_routed_experts``: the same kept (token, expert) pairs as the
    reference, then the same output; each case shows what it names."""
    arch, kw, t = ROUTING[case]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, seed=1)
    xt = _x((t, tcfg.d_model), seed=2)
    m = tcfg.moe
    want = jmoe._routed_experts(
        jnp.asarray(xt), jp["router"], jp["experts_w1"], jp["experts_w3"],
        jp["experts_w2"], cfg=jcfg, num_local_experts=m.num_experts,
        expert_offset=0)
    x = torch.from_numpy(xt)
    top_aff, top_idx = moe.route(x, tp["router"], tcfg, m.num_experts, 0)
    kept = _kept(top_aff, top_idx)
    assert kept == _ref_kept(xt, jp["router"], jcfg)
    cap = moe.capacity(tcfg, t)
    assert top_idx.shape == (m.num_experts, cap)
    if case == "oversubscribed":
        assert len(kept) < t * m.top_k                   # choices dropped
    if case == "undersubscribed":
        assert cap == t and len(kept) == t * m.top_k
        assert bool((top_aff == 0).any())                # filler slots
    if case == "capacity1":
        assert cap == 1
    got = moe._routed_experts(
        x, tp["router"], tp["experts_w1"], tp["experts_w3"],
        tp["experts_w2"], cfg=tcfg, num_local_experts=m.num_experts,
        expert_offset=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# id -> (arch, MoECfg changes): shared experts (deepseek), a dense
# residual (arctic), neither
FORWARD = {
    "shared": (DEEPSEEK, {}),
    "dense_residual": (ARCTIC, {}),
    "routed_only": (DEEPSEEK, {"num_shared": 0}),
}


@pytest.mark.parametrize("case", list(FORWARD))
def test_moe_forward_matches_reference(case):
    arch, kw = FORWARD[case]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, seed=3)
    assert ("shared" in tp) == bool(tcfg.moe.num_shared)
    assert ("dense" in tp) == tcfg.moe.dense_residual
    x = _x((2, 8, tcfg.d_model), seed=4)
    want = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    got = moe.moe_forward(tp, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_combine_equals_the_scatter_add_bit_for_bit(cf, dtype):
    """The deterministic combine gives the reference's scatter-add over
    the flattened [E, C] slots (``out.at[top_idx].add(y_e)``, filler
    slots of weight 0 included) bit for bit, in f32 and bf16, with drops
    (cf 0.5) and with filler (cf 4); top 4 of 8 experts, so the order of
    a token's sum shows in its bits.  In f32 it is also ``index_add_``'s
    sum on the CPU; in bf16 that one accumulates in f32 and rounds once,
    where XLA and the combine round after every add."""
    t = 64
    _, tcfg = _cfgs(DEEPSEEK, num_experts=8, top_k=4, capacity_factor=cf)
    m = tcfg.moe
    gen = make_generator(5, "cpu")
    router = torch.randn((tcfg.d_model, m.num_experts), generator=gen)
    xt = torch.randn((t, tcfg.d_model), generator=gen)
    top_aff, top_idx = moe.route(xt, router, tcfg, m.num_experts, 0)
    y = torch.randn((*top_idx.shape, tcfg.d_model), generator=gen)
    y_e = (y * top_aff[..., None]).to(dtype)
    got = moe.combine(y_e, top_aff, top_idx, t, m.top_k)
    assert got.dtype == dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    flat = y_e.reshape(-1, tcfg.d_model).float().numpy()
    want = jnp.zeros((t, tcfg.d_model), jdt).at[
        top_idx.reshape(-1).numpy()].add(jnp.asarray(flat).astype(jdt))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    if dtype == torch.float32:
        ref = torch.zeros((t, tcfg.d_model)).index_add_(
            0, top_idx.reshape(-1), y_e.reshape(-1, tcfg.d_model))
        assert torch.equal(got, ref)


@pytest.mark.parametrize("arch", [DEEPSEEK, ARCTIC])
def test_moe_aux_loss_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=6)
    x = _x((2, 8, tcfg.d_model), seed=7)
    want = jmoe.moe_aux_loss(jp, jcfg, jnp.asarray(x))
    got = moe.moe_aux_loss(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("case", ["shared", "dense_residual"])
def test_moe_forward_gradient_matches_jax_grad(case):
    """d(sum(moe_forward(p, x) * w)) / d(p, x) against ``jax.grad`` (with
    drops and filler: T = 16 at capacity 10)."""
    arch, kw = FORWARD[case]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, seed=8)
    x = _x((2, 8, tcfg.d_model), seed=9)
    w = _x((2, 8, tcfg.d_model), seed=10)

    def jf(p, xx):
        return jnp.sum(jmoe.moe_forward(p, jcfg, xx) * w)

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = (moe.moe_forward(tp, tcfg, xt) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(out, leaves + [xt])
    want = jax.tree_util.tree_leaves(jgp) + [jgx]
    assert len(grads) == len(want)
    for i, (g, j) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j),
                                   err_msg=f"leaf {i}", **TOL)


def _three_ranks(m: int):
    """What the layer reads of rank ``m``'s view of a (1, 3) mesh: no
    process behind it (the caller stubs the sum over the group)."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 3},
                                 group=lambda axis: ("model-group", axis),
                                 index=lambda axis: m if axis == "model"
                                 else 0)


@pytest.mark.parametrize("d_expert", [32, 48], ids=["whole", "hidden"])
def test_three_model_ranks_route_as_one_device(monkeypatch, d_expert):
    """On a model axis of 3, which does not divide the reduced deepseek's
    4 experts, each rank runs the reference's single-device branch: it
    routes the same tokens to the same experts, over all 4 of them, with
    the same capacity and the same dropped choices as one device (bit for
    bit).  At f = 32 the rule table leaves the stacks whole and a rank's
    output is one device's, with no sum over the group; at f = 48 each
    rank holds [E, d, 16] / [E, 16, d] and the three ranks' partial
    outputs (routed experts and the shared expert) sum to one device's.
    The sums over the group are recorded here, not run (no ranks); the
    sums on ranks are held in ``tests/test_torch_lm_mesh_moe.py``."""
    from repro_torch.launch.sharding import tree_param_shardings
    from repro_torch.models import ffn
    jcfg, tcfg = _cfgs(DEEPSEEK, capacity_factor=0.5, d_expert=d_expert)
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x((2, 8, tcfg.d_model), seed=11))
    routes, sums = [], []
    route = moe.route

    def spy(*args, **kw):
        out = route(*args, **kw)
        routes.append(out)
        return out

    def summed(t, group):
        sums.append(group)
        return t

    with torch.no_grad():
        want = moe.moe_forward(tp, tcfg, x)
        monkeypatch.setattr(moe, "route", spy)
        want_route = moe.route(x.reshape(-1, tcfg.d_model), tp["router"],
                               tcfg, tcfg.moe.num_experts, 0)
        monkeypatch.setattr(moe, "reduce_from", summed)
        monkeypatch.setattr(ffn, "reduce_from", summed)
        outs = []
        for m in range(3):
            mesh = _three_ranks(m)
            plans = tree_param_shardings(mesh, tp)
            local = {k: plans[k].local(v) for k, v in tp.items()
                     if k != "shared"}
            local["shared"] = {k: plans["shared"][k].local(v)
                               for k, v in tp["shared"].items()}
            with use_mesh(mesh):
                assert moe.expert_layout(tcfg) == (
                    "hidden" if d_expert == 48 else "whole")
                outs.append(moe.moe_forward(local, tcfg, x))
    e, t = tcfg.moe.num_experts, x.shape[0] * x.shape[1]
    for top_aff, top_idx in routes[1:]:
        assert top_aff.shape == (e, moe.capacity(tcfg, t))
        assert torch.equal(top_aff, want_route[0])
        assert torch.equal(top_idx, want_route[1])
    assert len(routes) == 4
    if d_expert == 32:
        assert sums == [None] * 3 * 2       # the routed and shared FFN
        for out in outs:
            assert torch.equal(out, want)
    else:
        assert sums == [("model-group", "model")] * 3 * 2
        np.testing.assert_allclose((outs[0] + outs[1] + outs[2]).numpy(),
                                   want.numpy(), **TOL)
