"""The hot-vocabulary cache (``repro_torch.data.vocab_cache``) against the
reference's (``repro.data.vocab_cache``), on the cases of
``tests/test_data_pipeline.py``: the same tables, seeds and token streams
go through both.

Tolerances: the host side (refreshed slots and token ids, assembled
batches, hit rates, inclusion probabilities, the meters' bytes) is equal
bit for bit, for both strategies under the same seed, and so is
``embed_with_cache`` (a gather); ``sampled_softmax_loss`` and its
gradients with respect to the hidden states, the gold rows and the cached
rows within 1e-6 (f32 sums in another order).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import vocab_cache as jvc  # noqa: E402
from repro.data.tokens import SyntheticCorpus  # noqa: E402
from repro.featurestore import TrafficMeter as JMeter  # noqa: E402
from repro_torch.data import vocab_cache as tvc  # noqa: E402
from repro_torch.featurestore import TrafficMeter  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-6
METER_FIELDS = ("bytes_cache_fill", "bytes_streamed", "bytes_sliced",
                "steps")
# (vocab, dim, fraction, zipf, seed) of the pipeline tests' caches
CASES = ((512, 16, 0.25, 1.2, 0), (2000, 16, 0.05, 1.3, 2),
         (2000, 8, 0.10, 1.3, 4))
STRATEGIES = ("sampled", "topk")


def _pair(vocab, dim, frac, strategy, seed):
    """The same table and config in both packages' caches."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    cfg_j = jvc.VocabCacheConfig(fraction=frac, strategy=strategy)
    cfg_t = tvc.VocabCacheConfig(fraction=frac, strategy=strategy)
    return (table, jvc.VocabCache(table, cfg_j, seed=seed),
            tvc.VocabCache(table, cfg_t, device="cpu", seed=seed))


def _stream(vocab, zipf, seed, steps=6):
    c = SyntheticCorpus(vocab, zipf_a=zipf, seed=seed)
    return [c.batch(0, s, batch=8, seq_len=64) for s in range(steps)]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", CASES)
def test_refresh_and_assembly_bit_for_bit(case, strategy):
    """Observe, refresh every other batch, assemble: slots, token ids,
    probabilities, batches, hit rates and meter bytes equal."""
    vocab, dim, frac, zipf, seed = case
    table, jc, tc = _pair(vocab, dim, frac, strategy, seed)
    jm, tm = JMeter(), TrafficMeter()
    for i, toks in enumerate(_stream(vocab, zipf, seed)):
        jc.observe(toks)
        tc.observe(toks)
        if i % 2 == 0:
            jc.refresh(i, jm)
            tc.refresh(i, tm)
            np.testing.assert_array_equal(tc.token_ids, jc.token_ids)
            np.testing.assert_array_equal(tc.slot_of, jc.slot_of)
            np.testing.assert_array_equal(tc.probs, jc.probs)
            np.testing.assert_array_equal(tc.table.numpy(),
                                          np.asarray(jc.table))
            assert tc.version == jc.version == i
        jb, tb = jc.assemble(toks, jm), tc.assemble(toks, tm)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tc.hit_rate(toks) == jc.hit_rate(toks)
    np.testing.assert_array_equal(tc.freq, jc.freq)
    for f in METER_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_embed_with_cache_bit_for_bit(strategy):
    """The lookup from cache rows and streamed rows equals the reference's
    and the full table's rows, bit for bit; ``assemble(device=)`` gives
    the same batch as tensors."""
    vocab, dim, frac, zipf, seed = CASES[1]
    table, jc, tc = _pair(vocab, dim, frac, strategy, seed)
    toks = _stream(vocab, zipf, seed, steps=1)[0]
    for c in (jc, tc):
        c.observe(toks)
        c.refresh(0)
    jb = jc.assemble(toks)
    want = np.asarray(jvc.embed_with_cache(
        jc.table, {k: jnp.asarray(v) for k, v in jb.items()}))
    tb = tc.assemble(toks, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in tb.values())
    got = tvc.embed_with_cache(tc.table, tb).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[toks])
    assert 0.0 < tc.hit_rate(toks) < 1.0       # both paths exercised


def test_embed_with_cache_when_every_token_hits():
    """A batch whose tokens are all cached streams no row (an empty
    ``[0, d]`` block): the reference's ``jnp.take`` refuses to index it
    and raises, the port returns the cached rows, the table's rows bit
    for bit (a divergence on purpose, ROADMAP Queue C; the first batch of
    a ``topk`` cache on the card is such a batch)."""
    table, jc, tc = _pair(512, 16, 0.25, "topk", 0)
    toks = np.random.default_rng(3).integers(0, 64, size=(4, 16))
    for c in (jc, tc):
        c.observe(np.tile(np.arange(64), 8))
        c.refresh(0)
    jb, tb = jc.assemble(toks), tc.assemble(toks, device="cpu")
    assert tb["streamed"].shape == (0, 16) and tc.hit_rate(toks) == 1.0
    with pytest.raises(IndexError, match="empty axis"):
        jvc.embed_with_cache(jc.table,
                             {k: jnp.asarray(v) for k, v in jb.items()})
    got = tvc.embed_with_cache(tc.table, tb).numpy()
    np.testing.assert_array_equal(got, table[toks])


@pytest.mark.parametrize("size_scale", (1, 7, 20, 40))
def test_inclusion_probs_equal(size_scale):
    """eq. 11 on the uniform prior and on a skewed frequency."""
    _, jc, tc = _pair(256, 16, size_scale / 40.0, "sampled", 0)
    ids = np.arange(256)
    np.testing.assert_array_equal(tc.inclusion_probs(ids),
                                  jc.inclusion_probs(ids))
    for c in (jc, tc):
        c.freq = np.arange(1, 257, dtype=np.float64)
        c.probs = c.freq / c.freq.sum()
    np.testing.assert_array_equal(tc.inclusion_probs(ids),
                                  jc.inclusion_probs(ids))


@pytest.mark.parametrize("coverage", ("full", "cache"))
def test_sampled_softmax_loss_and_gradients(coverage):
    """Loss and gradients within 1e-6 of the reference's (``jax.grad``):
    with the whole vocab cached at inclusion 1, and with a refreshed
    cache's rows and eq. 11 probabilities."""
    rng = np.random.default_rng(0)
    v, d, t = 64, 8, 32
    unembed = rng.standard_normal((v, d)).astype(np.float32)
    hidden = rng.standard_normal((t, d)).astype(np.float32)
    labels = rng.integers(0, v, t)
    if coverage == "full":
        neg, incl = unembed, np.ones((v,), np.float32)
    else:
        _, jc, _ = _pair(v, d, 0.25, "sampled", 1)
        jc.host_table = unembed
        jc.observe(_stream(v, 1.2, 1, steps=1)[0])
        jc.refresh(0)
        neg = unembed[jc.token_ids]
        incl = jc.inclusion_probs(jc.token_ids).astype(np.float32)
    args = (hidden, unembed[labels], neg)

    def jloss(h, rows, negs):
        return jvc.sampled_softmax_loss(h, jnp.asarray(labels), rows, negs,
                                        jnp.asarray(incl))
    want, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    got = tvc.sampled_softmax_loss(ts[0], torch.from_numpy(labels), ts[1],
                                   ts[2], torch.from_numpy(incl))
    tgrads = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    for g, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=TOL * np.abs(np.asarray(jg)).max())


def test_demo_twin_prints_the_reference_demo_lines():
    """``examples/vocab_cache_demo_torch.py`` prints the reference demo's
    hit rates and bytes line for line (small vocab, few steps)."""
    args = ["--vocab", "4000", "--dim", "16", "--steps", "8"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")

    def run(script, extra=()):
        out = subprocess.run([sys.executable, str(REPO / "examples" / script),
                              *args, *extra], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout.strip().splitlines()

    want = run("vocab_cache_demo.py")
    got = run("vocab_cache_demo_torch.py", ("--device", "cpu"))
    assert len(want) == 2 and got == want
