"""The port's MoE LM family against the reference: deepseek-v2-236b (MLA,
a dense first layer, shared experts) and arctic-480b (GQA, a dense
residual beside the experts) at their reduced configs (f32), with the
reference's own parameters (``params_from_numpy``): the init's layout,
the f32 router of a bf16 tree, the loss and every gradient, a prompt and
three decode steps, ``ServeEngine.generate_batch`` and ``train_loop``.

Tolerances: losses rtol 1e-5; gradients rtol 1e-4, atol 1e-5; logits
rtol 1e-4, atol 1e-5; caches rtol = atol = 1e-5 (the same f32 products,
summed in other orders by XLA and by PyTorch's CPU kernels); greedy
tokens exactly.  A served request's tokens depend on the batch it is
served in (an expert's capacity is shared by the batch's tokens), in both
packages alike.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro.launch.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402
from repro_torch.models.scan_util import tree_leaves  # noqa: E402

ARCHS = ["deepseek-v2-236b", "arctic-480b"]
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(c.get_config(arch).reduced(), **kw)
                 for c in (jconfigs, configs))


@pytest.fixture(scope="module")
def ref_params():
    """arch -> (reference params, the same as numpy)."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
        out[arch] = (jp, jax.tree_util.tree_map(np.asarray, jp))
    return out


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _dtypes(tree) -> list:
    return [str(t.dtype).split(".")[-1] for t in tree_leaves(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_layout(arch, dtype):
    """The port's own init: the reference's layer groups, keys, shapes and
    dtypes (router, norms f32 in bf16)."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    want = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    got = get_model(tcfg).init(0, device="cpu")
    assert set(got) == set(want)
    assert [(tuple(t.shape), d) for t, d in zip(tree_leaves(got),
                                                _dtypes(got))] == [
        (j.shape, str(j.dtype)) for j in jax.tree_util.tree_leaves(want)]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_keeps_the_router_f32(ref_params, arch):
    """Cast to bf16, the f32 reference tree keeps every router (and the
    norm scales) in f32, as the reference's bf16 init has them."""
    _, np_params = ref_params[arch]
    jcfg, _ = _cfgs(arch, dtype="bfloat16")
    want = [str(x.dtype) for x in jax.tree_util.tree_leaves(jax.eval_shape(
        jget_model(jcfg).init, jax.random.PRNGKey(0)))]
    got = params_from_numpy(np_params, device="cpu", dtype=torch.bfloat16)
    assert _dtypes(got) == want
    assert got["layers_moe"]["moe"]["router"].dtype == torch.float32
    assert got["layers_moe"]["moe"]["experts_w1"].dtype == torch.bfloat16


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(ref_params, arch, remat):
    jcfg, tcfg = _cfgs(arch, remat=remat)
    jp, np_params = ref_params[arch]
    toks = _tokens(tcfg, 2, 16, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jget_model(jcfg).loss))(
        jp, {"tokens": jnp.asarray(toks)})
    tparams = params_from_numpy(np_params, device="cpu")
    tloss, tgrads = value_and_grad(get_model(tcfg).loss, tparams,
                                   {"tokens": torch.from_numpy(toks)})
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    tleaves = tree_leaves(tgrads)
    assert len(tleaves) == len(jleaves)
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   err_msg=f"leaf {i}", **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(ref_params, arch):
    """A 9-token prompt and 3 single tokens through both packages'
    ``decode_step``: logits at every step and the caches after (MLA's
    compressed cache for deepseek, per-head K/V for arctic)."""
    jcfg, tcfg = _cfgs(arch)
    jp, np_params = ref_params[arch]
    tp = params_from_numpy(np_params, device="cpu")
    toks = _tokens(tcfg, 2, 12, seed=2)
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jstate, tstate = jm.decode_init(2, 16), tm.decode_init(2, 16,
                                                          device="cpu")
    jstep = jax.jit(jm.decode_step)
    feeds = [toks[:, :9]] + [toks[:, i:i + 1] for i in range(9, 12)]
    with torch.inference_mode():
        for feed in feeds:
            want, jstate = jstep(jp, jnp.asarray(feed), jstate)
            got, tstate = tm.decode_step(tp, torch.from_numpy(feed),
                                         tstate)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            assert tstate["pos"] == int(jstate["pos"])
    jl = jax.tree_util.tree_leaves(jstate["caches"])
    tl = tree_leaves(tstate["caches"])
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **CACHE_TOL)
    if tcfg.mla is not None:
        assert set(tstate["caches"]["layers_moe"]) == {"c_kv", "k_rope"}


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_batch_tokens_equal_reference_engine(ref_params, arch):
    """Both engines serve the same 3 requests (12-token prompts, 5 new
    tokens): greedy tokens identical and in the vocabulary."""
    jcfg, tcfg = _cfgs(arch)
    jp, np_params = ref_params[arch]
    tp = params_from_numpy(np_params, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, 12).astype(np.int32) for _ in range(3)]
    want = JServeEngine(jcfg, jp, max_batch=4).generate_batch(
        [JRequest(p, max_new_tokens=5) for p in prompts])
    got = ServeEngine(tcfg, tp, max_batch=4, device="cpu").generate_batch(
        [Request(p, max_new_tokens=5) for p in prompts])
    for g, w in zip(got, want):
        assert len(g.tokens) == 5
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert ((g.tokens >= 0) & (g.tokens < tcfg.vocab_size)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_matches_reference(ref_params, monkeypatch, arch):
    """Both packages' ``train_loop`` (2 steps, batch 2, seq 16, lr 1e-3)
    from the reference's parameters: the same losses, all finite."""
    from repro.launch import train as jtrain_mod
    jcfg, tcfg = _cfgs(arch)
    jp, np_params = ref_params[arch]
    jmodel = dataclasses.replace(jget_model(jcfg), init=lambda key: jp)
    tmodel = dataclasses.replace(
        get_model(tcfg), init=lambda seed=0, device=None: params_from_numpy(
            np_params, device=device))
    monkeypatch.setattr(jtrain_mod, "get_model", lambda cfg: jmodel)
    monkeypatch.setattr(train_mod, "get_model", lambda cfg: tmodel)
    kw = dict(steps=2, batch=2, seq_len=16, lr=1e-3, log_every=0)
    want = jtrain_mod.train_loop(jcfg, **kw)
    got = train_mod.train_loop(tcfg, device="cpu", **kw)
    assert len(got.losses) == 2 and all(np.isfinite(got.losses))
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
