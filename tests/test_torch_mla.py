"""The port's MLA attention (deepseek-v2's multi-head latent attention,
``repro_torch.models.attention``) against the reference's at the reduced
deepseek config in f32, with the reference's own parameters
(``params_from_numpy``): the init's layout, ``mla_forward`` without a
cache (the expand form), a prompt written into the compressed cache and
then single-token steps (the absorbed form) against the reference and
against the expand form over the same tokens, a second prompt chunk at an
offset, and the cache written in place.

Tolerances: rtol 1e-4, atol 1e-5 (the same f32 products, summed in other
orders by XLA and by PyTorch's CPU kernels, and by the absorbed and the
expand forms); cache rows rtol = atol = 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.common import make_generator  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402
from repro_torch.models.scan_util import tree_leaves  # noqa: E402

ARCH = "deepseek-v2-236b"
TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(dtype="float32"):
    return tuple(dataclasses.replace(c.get_config(ARCH).reduced(), dtype=dtype)
                 for c in (jconfigs, configs))


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = _cfgs()
    jp = jattn.init_attn(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tcfg, tp


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _pos(b, start, s):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None],
                           (b, s)).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_matches_reference_layout(dtype):
    """The reference's MLA keys, shapes and dtypes (``q_norm`` and
    ``kv_norm`` f32 in a bf16 model)."""
    jcfg, tcfg = _cfgs(dtype)
    want = jax.eval_shape(lambda k: jattn.init_attn(k, jcfg),
                          jax.random.PRNGKey(0))
    got = attn.init_attn(make_generator(0, "cpu"), tcfg)
    assert set(got) == set(want)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(got)] == [
        (j.shape, str(j.dtype)) for j in jax.tree_util.tree_leaves(want)]
    assert got["q_norm"].dtype == got["kv_norm"].dtype == torch.float32


def test_mla_forward_without_cache_matches_reference(both):
    jcfg, jp, tcfg, tp = both
    x = _x(2, 10, tcfg.d_model, seed=1)
    pos = _pos(2, 0, 10)
    want, jc = jattn.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, tc = attn.attn_forward(tp, tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
    assert jc is None and tc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prefill_then_decode(jcfg, jp, tcfg, tp, x, chunks, cache_len):
    """Feed ``x`` [B, S, d] in ``chunks`` (token counts) through both
    packages' ``mla_forward`` with a cache; (port outputs, reference
    outputs, port cache, reference cache), outputs per chunk."""
    b = x.shape[0]
    jcache = jattn.init_mla_cache(jcfg, b, cache_len)
    tcache = attn.init_mla_cache(tcfg, b, cache_len, device="cpu")
    got, want, pos = [], [], 0
    for n in chunks:
        feed = x[:, pos:pos + n]
        p = _pos(b, pos, n)
        out, jcache = jattn.mla_forward(jp, jcfg, jnp.asarray(feed),
                                        jnp.asarray(p), kv_cache=jcache,
                                        cache_pos=pos)
        want.append(np.asarray(out))
        out, tcache = attn.mla_forward(tp, tcfg, torch.from_numpy(feed),
                                       torch.from_numpy(p), kv_cache=tcache,
                                       cache_pos=pos)
        got.append(out.numpy())
        pos += n
    return got, want, tcache, jcache


@pytest.mark.parametrize("chunks", [(7, 1, 1, 1), (5, 3, 1, 1)],
                         ids=["prompt-then-3-steps", "two-chunks-then-2"])
def test_mla_cache_path_matches_reference_and_expand_form(both, chunks):
    """Prompt chunks (the expand form over the written cache, positional
    mask) and single tokens (the absorbed form) against the reference's
    outputs and caches, and against ``mla_forward`` without a cache over
    the same tokens (causal: each chunk's rows are that forward's rows)."""
    jcfg, jp, tcfg, tp = both
    s = sum(chunks)
    x = _x(2, s, tcfg.d_model, seed=2)
    got, want, tcache, jcache = _prefill_then_decode(jcfg, jp, tcfg, tp, x,
                                                     chunks, cache_len=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **CACHE_TOL)
    with torch.inference_mode():
        full, _ = attn.mla_forward(tp, tcfg, torch.from_numpy(x),
                                   torch.from_numpy(_pos(2, 0, s)))
    np.testing.assert_allclose(np.concatenate(got, axis=1), full.numpy(),
                               **TOL)


def test_mla_cache_is_written_in_place(both):
    """Each call writes its rows into the given ``c_kv`` / ``k_rope``
    tensors and returns the same dict; rows past the fed tokens stay 0."""
    _, _, tcfg, tp = both
    x = torch.from_numpy(_x(2, 6, tcfg.d_model, seed=3))
    cache = attn.init_mla_cache(tcfg, 2, 12, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    with torch.inference_mode():
        _, c1 = attn.mla_forward(tp, tcfg, x[:, :5],
                                 torch.from_numpy(_pos(2, 0, 5)),
                                 kv_cache=cache, cache_pos=0)
        _, c2 = attn.mla_forward(tp, tcfg, x[:, 5:],
                                 torch.from_numpy(_pos(2, 5, 1)),
                                 kv_cache=cache, cache_pos=5)
    assert c1 is cache and c2 is cache
    m = tcfg.mla
    assert tuple(cache["c_kv"].shape) == (2, 12, m.kv_lora)
    assert tuple(cache["k_rope"].shape) == (2, 12, m.qk_rope)
    for k, t in cache.items():
        assert t.data_ptr() == ptrs[k]
        assert bool((t[:, :6] != 0).any(-1).all())
        assert not bool(t[:, 6:].any())
