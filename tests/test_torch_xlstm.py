"""The port's xLSTM cells (``repro_torch.models.xlstm``) against the
reference's ``repro.models.xlstm``: mLSTM in its parallel, chunked and
recurrent forms, the chunked cell at chunks 4, 6 and 12 against the
parallel cell (the reference's ``tests/test_perf_variants.py`` cases) and
in a chunk-8 full model, and the sLSTM, with gradients through both.

Inputs come from numpy seeds; parameters are the reference's own
(``params_from_numpy``) at the reduced xlstm-125m config (f32).
Tolerances: rtol 1e-4, atol 1e-5, outputs and gradients (of the mean
over tokens of |out|^2); the chunked cell against the parallel one rtol
2e-4, atol 2e-5, the reference's own tolerance for that pair
(stabilizers taken per chunk, then rescaled).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402
from repro_torch.models.scan_util import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "xlstm-125m"


def _cfgs(**xl_kw):
    j = jconfigs.get_config(ARCH).reduced()
    t = configs.get_config(ARCH).reduced()
    if xl_kw:
        j = dataclasses.replace(j, xlstm=dataclasses.replace(j.xlstm, **xl_kw))
        t = dataclasses.replace(t, xlstm=dataclasses.replace(t.xlstm, **xl_kw))
    return j, t


def _cell(init, jcfg, seed=0):
    jp = init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(cfg, s, seed, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _grads_close(fwd_t, tp, fwd_j, jp):
    """Gradients of the mean over tokens of |out|^2 w.r.t. every
    parameter, both packages (largest gradient about 0.5)."""
    jg = jax.grad(lambda p: jnp.mean(jnp.sum(fwd_j(p) ** 2, -1)))(jp)
    _, tg = value_and_grad(lambda p, _: fwd_t(p).square().sum(-1).mean(),
                           tp, None)
    jl = jax.tree_util.tree_leaves(jg)
    tl = tree_leaves(tg)
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **TOL)


def test_mlstm_parallel_matches_reference_with_grads():
    jcfg, tcfg = _cfgs()
    jp, tp = _cell(jxl.init_mlstm, jcfg)
    x = _x(tcfg, 12, 0)
    jy, _ = jxl.mlstm_forward(jp, jcfg, jnp.asarray(x))
    ty, st = xl.mlstm_forward(tp, tcfg, _t(x))
    assert st is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _grads_close(lambda p: xl.mlstm_forward(p, tcfg, _t(x))[0], tp,
                 lambda p: jxl.mlstm_forward(p, jcfg, jnp.asarray(x))[0], jp)


@pytest.mark.parametrize("chunk", [4, 6, 12])
def test_mlstm_chunked_cell_matches_reference_and_parallel(chunk):
    rng = np.random.default_rng(2)
    b, h, s, d = 2, 3, 24, 8
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    i_raw = (rng.standard_normal((b, h, s)) * 2).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(
        jnp.asarray(rng.standard_normal((b, h, s)).astype(np.float32))))
    want = jxl._mlstm_chunked(*(jnp.asarray(a) for a in (q, k, v, i_raw,
                                                         logf)), chunk)
    got = xl._mlstm_chunked(*(_t(a) for a in (q, k, v, i_raw, logf)), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the parallel form of the same cell (the reference test's algebra)
    qt, kt, vt, it, lt = (_t(a) for a in (q, k, v, i_raw, logf))
    fcum = torch.cumsum(lt, -1)
    dmat, m = xl._causal_max(fcum[..., :, None] - fcum[..., None, :]
                             + it[..., None, :], s)
    cw = torch.einsum("bhtd,bhsd->bhts", qt, kt) * torch.exp(
        dmat - m[..., None])
    ref = torch.einsum("bhts,bhsv->bhtv", cw, vt) / torch.maximum(
        cw.sum(-1).abs(), torch.exp(-m))[..., None]
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


def test_mlstm_chunked_forward_matches_reference_with_grads():
    """``cfg.xlstm.chunk`` 4 at S = 16 takes the chunked branch in both
    packages."""
    jcfg, tcfg = _cfgs(chunk=4)
    jp, tp = _cell(jxl.init_mlstm, jcfg, seed=1)
    x = _x(tcfg, 16, 1)
    jy, _ = jxl.mlstm_forward(jp, jcfg, jnp.asarray(x))
    ty, _ = xl.mlstm_forward(tp, tcfg, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _grads_close(lambda p: xl.mlstm_forward(p, tcfg, _t(x))[0], tp,
                 lambda p: jxl.mlstm_forward(p, jcfg, jnp.asarray(x))[0], jp)


def test_chunked_mlstm_full_model():
    """The reduced model's loss with ``chunk=8`` equals the parallel form's
    at S = 32 (rtol 1e-5, the reference's), and the reference's chunk-8
    loss."""
    jcfg, tcfg = _cfgs()
    jcfg8, tcfg8 = _cfgs(chunk=8)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    with torch.no_grad():
        plain = float(get_model(tcfg).loss(tp, {"tokens": _t(toks)}))
        chunked = float(get_model(tcfg8).loss(tp, {"tokens": _t(toks)}))
    np.testing.assert_allclose(chunked, plain, rtol=1e-5)
    want = float(jget_model(jcfg8).loss(jp, {"tokens": jnp.asarray(toks)}))
    np.testing.assert_allclose(chunked, want, rtol=1e-5)


def test_mlstm_recurrent_matches_reference_and_parallel():
    """A 7-token prompt and then 3 single tokens from the zero state:
    outputs and C/n/m against the reference's at every call (in place),
    and the outputs against the parallel form over the 10 tokens."""
    jcfg, tcfg = _cfgs()
    jp, tp = _cell(jxl.init_mlstm, jcfg, seed=2)
    x = _x(tcfg, 10, 3)
    jst = jxl.init_mlstm_state(jcfg, 2)
    tst = xl.init_mlstm_state(tcfg, 2, device="cpu")
    np.testing.assert_array_equal(tst["m"].numpy(), np.asarray(jst["m"]))
    assert tst["c"].dtype == torch.float32
    outs = []
    with torch.inference_mode():
        for lo, hi in [(0, 7), (7, 8), (8, 9), (9, 10)]:
            jy, jst = jxl.mlstm_forward(jp, jcfg, jnp.asarray(x[:, lo:hi]),
                                        state=jst)
            ty, got = xl.mlstm_forward(tp, tcfg, _t(x[:, lo:hi]), state=tst)
            assert got is tst
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
            for k in ("c", "n", "m"):
                np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                           **TOL)
            outs.append(ty)
        full, _ = xl.mlstm_forward(tp, tcfg, _t(x))
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_slstm_matches_reference_with_grads_and_state():
    jcfg, tcfg = _cfgs()
    jp, tp = _cell(jxl.init_slstm, jcfg, seed=4)
    x = _x(tcfg, 9, 4)
    jy, jst = jxl.slstm_forward(jp, jcfg, jnp.asarray(x))
    ty, st = xl.slstm_forward(tp, tcfg, _t(x))
    assert st is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _grads_close(lambda p: xl.slstm_forward(p, tcfg, _t(x))[0], tp,
                 lambda p: jxl.slstm_forward(p, jcfg, jnp.asarray(x))[0], jp)
    # carried: 6 tokens then 3 from the state, against the 9 at once
    tst = xl.init_slstm_state(tcfg, 2, device="cpu")
    with torch.inference_mode():
        a, _ = xl.slstm_forward(tp, tcfg, _t(x[:, :6]), state=tst)
        b, got = xl.slstm_forward(tp, tcfg, _t(x[:, 6:]), state=tst)
    assert got is tst
    torch.testing.assert_close(torch.cat([a, b], 1), ty.detach(), **TOL)
    for k in ("h", "c", "n", "m"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)


def test_init_cells_match_reference_layout():
    from repro_torch.models.common import make_generator
    jcfg, tcfg = _cfgs()
    for jinit, tinit in ((jxl.init_mlstm, xl.init_mlstm),
                         (jxl.init_slstm, xl.init_slstm)):
        jp = jinit(jax.random.PRNGKey(0), jcfg)
        tp = tinit(make_generator(0, "cpu"), tcfg)
        assert sorted(tp) == sorted(jp)
        assert {k: tuple(v.shape) for k, v in tp.items()} == {
            k: v.shape for k, v in jp.items()}
    bf = xl.init_slstm(make_generator(0, "cpu"),
                       dataclasses.replace(tcfg, dtype="bfloat16"))
    assert {k for k, v in bf.items() if v.dtype == torch.float32} == {
        "b_gates", "norm_scale"}
