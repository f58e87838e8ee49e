"""The port's Mamba2 block (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm``: the causal conv with and without a
carried state, the chunked SSD at chunk sizes that divide S and at sizes
that shrink until they do, ``ssm_forward`` in its chunked and recurrent
branches, and the decay matrix masked before its ``exp`` (a divergence
on purpose: the same values, a finite gradient where the reference's
overflows).

Inputs come from numpy seeds; the block's parameters are the reference's
own (``params_from_numpy``) at the reduced zamba2 config (f32).
Tolerances: rtol 1e-4, atol 1e-5 (f32; XLA and PyTorch sum the same
products in other orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "zamba2-2.7b"


def _cfgs(**ssm_kw):
    j = jconfigs.get_config(ARCH).reduced()
    t = configs.get_config(ARCH).reduced()
    if ssm_kw:
        j = dataclasses.replace(j, ssm=dataclasses.replace(j.ssm, **ssm_kw))
        t = dataclasses.replace(t, ssm=dataclasses.replace(t.ssm, **ssm_kw))
    return j, t


def _block(jcfg, seed=0):
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(np_p, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    b, s, c, k = 2, 7, 12, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    st = (rng.standard_normal((b, k - 1, c)).astype(np.float32)
          if with_state else None)
    jy, jst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias),
                                None if st is None else jnp.asarray(st))
    ty, tst = ssm._causal_conv(_t(x), _t(w), _t(bias),
                               None if st is None else _t(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_causal_conv_state_takes_the_activation_dtype():
    """A bf16 input with an f32 state hands back a bf16 state (the
    reference's dtype after its first step) holding the last K-1 inputs."""
    x = torch.randn((1, 3, 4)).bfloat16()
    w = torch.randn((4, 4)).bfloat16()
    _, st = ssm._causal_conv(x, w, torch.zeros(4).bfloat16(),
                             torch.zeros((1, 3, 4)))
    assert st.dtype == torch.bfloat16 and torch.equal(st, x)


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 16), (24, 24), (30, 8),
                                     (21, 16), (7, 4), (5, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    """Chunks that divide S, and ones that shrink (30 -> 6, 21 -> 7,
    7 -> 1, min(16, 5) = 5)."""
    rng = np.random.default_rng(s * 100 + chunk)
    b, h, n, p = 2, 3, 5, 4
    decay = rng.uniform(0.5, 1.0, (b, s, h)).astype(np.float32)
    bbh = rng.standard_normal((b, s, h, n)).astype(np.float32)
    cch = rng.standard_normal((b, s, h, n)).astype(np.float32)
    dx = rng.standard_normal((b, s, h, p)).astype(np.float32)
    want = jssm._ssd_chunked(*(jnp.asarray(a) for a in (decay, bbh, cch, dx)),
                             chunk)
    got = ssm._ssd_chunked(*(_t(a) for a in (decay, bbh, cch, dx)), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_chunked_equals_one_chunk():
    """Chunked at 4 and as one chunk of the whole sequence give the same
    output (the inter-chunk states carry exactly)."""
    rng = np.random.default_rng(5)
    args = [_t(rng.uniform(0.6, 1.0, (1, 16, 2)).astype(np.float32))] + [
        _t(rng.standard_normal((1, 16, 2, d)).astype(np.float32))
        for d in (3, 3, 4)]
    torch.testing.assert_close(ssm._ssd_chunked(*args, 4),
                               ssm._ssd_chunked(*args, 16), **TOL)


def test_init_ssm_matches_reference_layout():
    jcfg, tcfg = _cfgs()
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    from repro_torch.models.common import make_generator
    tp = ssm.init_ssm(make_generator(0, "cpu"), tcfg)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(jp[k].dtype), k
    for k in ("a_log", "ssm_d", "dt_bias", "conv_b", "norm_scale"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, err_msg=k)
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    tb = ssm.init_ssm(make_generator(0, "cpu"), bf)
    assert {k for k, v in tb.items() if v.dtype == torch.float32} == {
        "a_log", "ssm_d", "dt_bias", "norm_scale"}


@pytest.mark.parametrize("chunk", [16, 5])
def test_ssm_forward_chunked_matches_reference(chunk):
    jcfg, tcfg = _cfgs(chunk=chunk)
    jp, tp = _block(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 20, tcfg.d_model)).astype(np.float32)
    jy, jst = jssm.ssm_forward(jp, jcfg, jnp.asarray(x))
    ty, tst = ssm.ssm_forward(tp, tcfg, _t(x))
    assert jst is None and tst is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_ssm_forward_recurrent_matches_reference_and_chunked():
    """The recurrent branch over a 9-token prompt and then 3 single tokens
    from a zero state: outputs and states against the reference's at
    every call (updated in place, the same dict back), and the outputs
    against the chunked form over the 12 tokens."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block(jcfg, seed=3)
    x = np.random.default_rng(2).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    jstate = jssm.init_ssm_state(jcfg, 2)
    tstate = ssm.init_ssm_state(tcfg, 2, device="cpu")
    bufs = dict(tstate)
    outs = []
    with torch.inference_mode():
        for lo, hi in [(0, 9), (9, 10), (10, 11), (11, 12)]:
            jy, jstate = jssm.ssm_forward(jp, jcfg, jnp.asarray(x[:, lo:hi]),
                                          state=jstate)
            ty, got = ssm.ssm_forward(tp, tcfg, _t(x[:, lo:hi]), state=tstate)
            assert got is tstate
            assert all(tstate[k] is bufs[k] for k in bufs)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
            for k in ("conv", "ssd"):
                np.testing.assert_allclose(tstate[k].numpy(),
                                           np.asarray(jstate[k]), **TOL)
            outs.append(ty)
        full, _ = ssm.ssm_forward(tp, tcfg, _t(x))
    torch.testing.assert_close(torch.cat(outs, dim=1), full, **TOL)


def test_intra_decay_masks_before_exp_with_the_reference_values():
    """The decay matrix takes ``exp`` after its mask (ROADMAP.md Queue C
    item 9): bit for bit the reference's order (``exp`` of every entry,
    then the mask) in torch, on sums past e^88 that overflow above the
    diagonal; allclose to the reference's own."""
    rng = np.random.default_rng(7)
    cum = np.cumsum(-rng.uniform(4.0, 12.0, (2, 3, 16, 4)),
                    axis=2).astype(np.float32)            # about -128 at 16
    t = _t(cum)
    lt = t[:, :, :, None, :] - t[:, :, None, :, :]
    mask = torch.ones((16, 16), dtype=torch.bool).tril()[None, None, ...,
                                                          None]
    ref_order = torch.where(mask, torch.exp(lt), 0.0)
    assert bool(torch.isinf(torch.exp(lt)).any())
    got = ssm._intra_decay(t)
    assert torch.equal(got, ref_order)
    jc = jnp.asarray(cum)
    jlt = jc[:, :, :, None, :] - jc[:, :, None, :, :]
    want = jnp.where(jnp.asarray(mask.numpy()), jnp.exp(jlt), 0.0)
    # XLA flushes subnormal results to zero; torch keeps them
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)


def test_ssd_chunked_gradient_is_finite_where_the_reference_overflows():
    """A chunk of 32 steps of decay 1e-2 sums to e^-147: the reference's
    gradient is NaN (0 · inf behind its mask), the port's finite, and the
    two forwards agree."""
    rng = np.random.default_rng(8)
    b, s, h, n, p = 1, 32, 2, 3, 4
    decay = np.full((b, s, h), 1e-2, np.float32)
    bbh, cch = (rng.standard_normal((b, s, h, n)).astype(np.float32)
                for _ in range(2))
    dx = rng.standard_normal((b, s, h, p)).astype(np.float32)

    def jloss(d):
        return jnp.sum(jssm._ssd_chunked(d, *(jnp.asarray(a) for a in
                                              (bbh, cch, dx)), 32) ** 2)

    jgrad = jax.grad(jloss)(jnp.asarray(decay))
    assert bool(jnp.isnan(jgrad).any())
    td = _t(decay).requires_grad_(True)
    out = ssm._ssd_chunked(td, *(_t(a) for a in (bbh, cch, dx)), 32)
    (g,) = torch.autograd.grad(out.square().sum(), td)
    assert bool(torch.isfinite(g).all())
    want = jssm._ssd_chunked(*(jnp.asarray(a) for a in (decay, bbh, cch,
                                                         dx)), 32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
