"""The port's AdamW over slices of a leaf (``optim/adam.py``,
``SLICE_ELEMENTS``) against the whole-leaf update and the reference.

* The sliced update is bit for bit the whole-leaf update (elementwise
  arithmetic does not depend on where a slice starts), with the constant
  cut so every leaf is sliced raggedly, on the flattened storage and, for a
  non-contiguous gradient, along the first dim.  Where clipping is on,
  ``clip_norm`` sits above the gradients' norm, so the scale is exactly 1
  in both forms.
* The sliced clipping norm sums a leaf's squares in another order: it is
  held within rtol 1e-6 of the whole-leaf norm and of the reference's
  ``clip_by_global_norm``.  Each leaf here is cut into at most 20 slices,
  as deepseek-v2-236b's largest leaf (1,258,291,200 elements) is cut into
  19 at the default; f32 partial sums of that many slices stay near f32's
  epsilon (6e-8), well inside 1e-6.
* Reduced deepseek-v2-236b through both packages' ``train_loop``: the
  losses with a small constant within rtol 1e-6 of the default's (the
  norm's order differs, so the bits may), and within the reference's
  rtol 1e-5 (``tests/test_torch_moe_lm.py``'s ``LOSS_RTOL``).
* On a card only (``-m gpu``): a leaf of three slices and a ragged tail,
  updated sliced and as one slice, bit for bit (``chip_smoke.py``'s
  ``lm-train-moe`` (a) at a smaller leaf).  That test needs no jax.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import requires_cuda  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402
from repro_torch.models.scan_util import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

NORM_RTOL = 1e-6
LOSS_RTOL = 1e-5                  # tests/test_torch_moe_lm.py's
SHAPES = {"a": (37, 29), "b": (5,), "c": [(3, 4, 100), ()], "d": (41, 31)}


def _tree(rng, dtype, shapes=SHAPES, scale=1.0):
    def leaf(s):
        if isinstance(s, list):
            return [leaf(x) for x in s]
        return torch.from_numpy(np.asarray(
            rng.normal(size=s) * scale, np.float32)).to(dtype)
    return {k: leaf(s) for k, s in shapes.items()}


def _grads(rng, dtype):
    """Gradients of ``SHAPES``, ``d``'s a transposed (non-contiguous)
    view, so its update is sliced along its first dim."""
    g = _tree(rng, dtype, scale=1e-3)
    g["d"] = g["d"].T.contiguous().T
    assert not g["d"].is_contiguous()
    return g


@pytest.mark.parametrize("clip", [None, 1e3])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slice_elements", [1000, 7])
def test_sliced_update_is_the_whole_leaf_update(monkeypatch, slice_elements,
                                                dtype, moments, weight_decay,
                                                clip):
    rng = np.random.default_rng(0)
    cfg = adam.AdamConfig(lr=1e-2, weight_decay=weight_decay, clip_norm=clip,
                          moment_dtype=moments)
    opt = adam.AdamW(cfg)
    whole = _tree(rng, dtype)
    sliced = _tree(np.random.default_rng(0), dtype)
    s_whole, s_sliced = opt.init(whole), opt.init(sliced)
    for _ in range(3):
        g = _grads(rng, dtype)
        if clip is not None:
            assert float(adam.global_norm(g)) < clip
        opt.update(g, s_whole, whole)
        with monkeypatch.context() as mp:
            mp.setattr(adam, "SLICE_ELEMENTS", slice_elements)
            assert len(adam.leaf_slices(g["a"])) > 1
            assert len(adam.leaf_slices(g["d"])) > 1
            opt.update(g, s_sliced, sliced)
        for a, b in zip(tree_leaves([whole, s_whole["m"], s_whole["v"]]),
                        tree_leaves([sliced, s_sliced["m"],
                                     s_sliced["v"]])):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_one_slice_leaves_are_the_leaves_themselves():
    """A leaf of at most one slice is updated whole, as before slicing."""
    t = torch.zeros(adam.SLICE_ELEMENTS)
    (got,), = adam.leaf_slices(t)
    assert got is t


@pytest.fixture(scope="module")
def ref_adam():
    pytest.importorskip("jax")
    from repro.optim import adam as ref
    return ref


# (constant, leaf shapes): every leaf cut into at most 20 slices (module
# docstring), the last ragged
NORM_CASES = [(1000, {"a": (97, 201), "b": (1000,), "c": (19_001,)}),
              (7, {"a": (11, 12), "b": (7,), "c": (3, 45)})]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slice_elements,shapes", NORM_CASES)
def test_sliced_norm_matches_whole_and_reference(monkeypatch, ref_adam,
                                                 slice_elements, shapes,
                                                 dtype):
    import jax.numpy as jnp
    g = _tree(np.random.default_rng(1), dtype, shapes)
    whole = float(adam.global_norm(g))
    monkeypatch.setattr(adam, "SLICE_ELEMENTS", slice_elements)
    assert max(len(adam.leaf_slices(t)) for t in tree_leaves(g)) <= 20
    sliced = float(adam.global_norm(g))
    _, want = ref_adam.clip_by_global_norm(
        {k: jnp.asarray(v.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
         for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(sliced, whole, rtol=NORM_RTOL)
    np.testing.assert_allclose(sliced, float(want), rtol=NORM_RTOL)


@pytest.fixture(scope="module")
def deepseek_reduced():
    """(reference config, port config, reference params, as numpy)."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models.lm import get_model as jget_model
    jcfg = jconfigs.get_config("deepseek-v2-236b").reduced()
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    return (jcfg, get_config("deepseek-v2-236b").reduced(), jp,
            jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("slice_elements", [1000, 7])
def test_train_loop_sliced_matches_default_and_reference(
        monkeypatch, deepseek_reduced, slice_elements):
    """Both packages' ``train_loop`` (3 steps, batch 2, seq 16, lr 1e-3)
    from the reference's parameters."""
    from repro.launch import train as jtrain_mod
    from repro.models.lm import get_model as jget_model
    jcfg, tcfg, jp, np_params = deepseek_reduced
    jmodel = dataclasses.replace(jget_model(jcfg), init=lambda key: jp)
    tmodel = dataclasses.replace(
        get_model(tcfg), init=lambda seed=0, device=None: params_from_numpy(
            np_params, device=device))
    monkeypatch.setattr(jtrain_mod, "get_model", lambda cfg: jmodel)
    monkeypatch.setattr(train_mod, "get_model", lambda cfg: tmodel)
    kw = dict(steps=3, batch=2, seq_len=16, lr=1e-3, log_every=0)
    want = jtrain_mod.train_loop(jcfg, **kw).losses
    whole = train_mod.train_loop(tcfg, device="cpu", **kw).losses
    monkeypatch.setattr(adam, "SLICE_ELEMENTS", slice_elements)
    leaves = tree_leaves(tmodel.init(device="cpu"))
    assert max(t.numel() for t in leaves) > slice_elements
    sliced = train_mod.train_loop(tcfg, device="cpu", **kw).losses
    assert len(sliced) == 3 and all(np.isfinite(sliced))
    np.testing.assert_allclose(sliced, whole, rtol=NORM_RTOL)
    np.testing.assert_allclose(sliced, want, rtol=LOSS_RTOL)


@pytest.mark.gpu
def test_sliced_update_is_the_one_slice_update_on_card(monkeypatch):
    """A bf16 leaf of three slices and a ragged tail (f32 moments, weight
    decay 0.1, no clipping), updated sliced and as one slice."""
    dev = requires_cuda()
    limit = 2 ** 20
    n = 3 * limit + 12_345
    gen = torch.Generator(device=dev).manual_seed(0)
    p, g, m = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    v = torch.rand(n, generator=gen, device=dev)
    p, g = p.bfloat16(), (g * 1e-3).bfloat16()
    opt = adam.AdamW(adam.AdamConfig(lr=1e-2, weight_decay=0.1))
    out = {}
    for name, elements in (("sliced", limit), ("one", n)):
        monkeypatch.setattr(adam, "SLICE_ELEMENTS", elements)
        state = {"m": [m.clone()], "v": [v.clone()], "step": 0}
        params = [p.clone()]
        opt.update([g], state, params)
        out[name] = (params[0], state["m"][0], state["v"][0])
    assert len(adam.leaf_slices(p)) == 1
    monkeypatch.setattr(adam, "SLICE_ELEMENTS", limit)
    assert len(adam.leaf_slices(p)) == 4
    for a, b in zip(out["sliced"], out["one"]):
        assert torch.equal(a, b)
