"""The port's token pipeline (``repro_torch.data.tokens``, a numpy copy)
against the reference's: ``SyntheticCorpus`` batches and ``TokenPipeline``
epochs bit for bit, across hosts, microbatch layouts, extra builders and a
``start_step`` resume."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data import tokens as ref  # noqa: E402
from repro_torch.data import SyntheticCorpus, TokenPipeline  # noqa: E402


@pytest.mark.parametrize("vocab,zipf_a,seed", [(512, 1.2, 0), (256_206, 1.2, 3),
                                               (1000, 1.05, 7)])
def test_corpus_batches_equal_reference(vocab, zipf_a, seed):
    ours = SyntheticCorpus(vocab, zipf_a=zipf_a, seed=seed)
    theirs = ref.SyntheticCorpus(vocab, zipf_a=zipf_a, seed=seed)
    for epoch, step, host, hosts in ((0, 0, 0, 1), (1, 5, 1, 2), (2, 9, 3, 4)):
        a = ours.batch(epoch, step, 8, 16, host, hosts)
        b = theirs.batch(epoch, step, 8, 16, host, hosts)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert a.shape == (8 // hosts, 16) and int(a.max()) < vocab


def _frames(epoch, step, a, b):
    return np.random.default_rng(epoch * 1_000_003 + step).standard_normal(
        (a, b, 3, 4)).astype(np.float32)


@pytest.mark.parametrize("accum", [1, 2])
def test_pipeline_epochs_equal_reference_and_resume(accum):
    """An epoch of 5 batches ([accum, B/accum, S] tokens plus an extra
    builder's array) equals the reference's; ``start_step=3`` yields the
    tail of the same stream."""
    kw = dict(accum=accum, host=1, num_hosts=2, prefetch=2,
              extra_builders={"frame_embeds": _frames})
    ours = TokenPipeline(SyntheticCorpus(300, seed=2), 8, 12, **kw)
    theirs = ref.TokenPipeline(ref.SyntheticCorpus(300, seed=2), 8, 12, **kw)
    a = list(ours.epoch(1, 5))
    b = list(theirs.epoch(1, 5))
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y) == ["frame_embeds", "tokens"]
        assert x["tokens"].shape == (accum, 4 // accum, 12)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    tail = list(ours.epoch(1, 5, start_step=3))
    assert len(tail) == 2
    for x, y in zip(tail, a[3:]):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
