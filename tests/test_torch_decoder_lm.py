"""The port's decoder-only serving against the reference: the reduced
``h2o-danube-3-4b`` (f32, sliding window 16) through its ring cache, the
dense cache of reduced ``gemma-2b``, ``internvl2-1b`` and ``starcoder2-7b``
(attention biases, the non-gated GELU FFN, an untied unembedding),
``ServeEngine``'s greedy tokens, and where the K4 op is (never) called on
these paths.

Inputs come from numpy seeds, parameters are the reference's own
(``params_from_numpy``).  Tolerances: logits rtol 1e-4, atol 1e-5 against
the reference's ``lm_decode_step`` and against a full ``lm_forward`` over
the same tokens (the same f32 matmuls summed in other orders); ring
``slot_pos`` and greedy tokens exactly.
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
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step, value_and_grad)
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402

DANUBE = "h2o-danube-3-4b"
TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(arch, impl="reference"):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               attn_impl=impl)
    tcfg = dataclasses.replace(configs.get_config(arch).reduced(),
                               attn_impl=impl)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def danube():
    return _pair(DANUBE)


def _decode_both(jcfg, jp, tcfg, tp, toks, prompt, cache_len):
    """Prefill ``prompt`` tokens, then one teacher-forced token per step,
    through both packages; returns (port logits, reference logits, port
    state, reference state)."""
    jstate = jtransformer.init_decode_state(jcfg, toks.shape[0], cache_len)
    tstate = transformer.init_decode_state(tcfg, toks.shape[0], cache_len,
                                           device="cpu")
    jstep = jax.jit(lambda p, t, s: jtransformer.lm_decode_step(p, jcfg, t, s))
    feeds = [toks[:, :prompt]] + [toks[:, i:i + 1]
                                  for i in range(prompt, toks.shape[1])]
    tl, jl = [], []
    with torch.inference_mode():
        for feed in feeds:
            logits, jstate = jstep(jp, jnp.asarray(feed), jstate)
            jl.append(np.asarray(logits))
            logits, tstate = transformer.lm_decode_step(
                tp, tcfg, torch.from_numpy(feed), tstate)
            tl.append(logits.numpy())
            assert tstate["pos"] == int(jstate["pos"])
    return np.stack(tl, 1), np.stack(jl, 1), tstate, jstate


def test_ring_decode_matches_reference_and_full_forward(danube):
    """A 20-token prefill into a 16-slot ring (it wraps in the prefill),
    then 12 single-token steps: logits against the reference's at every
    step and against a full ``lm_forward`` (no cache) over the 32 tokens;
    the ring's ``slot_pos`` holds the last 16 absolute positions, equal to
    the reference's, and its K/V rows equal the reference's."""
    jcfg, jp, tcfg, tp = danube
    assert tcfg.sliding_window == 16
    b, prompt, steps = 2, 20, 12
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (b, prompt + steps)).astype(np.int32)
    got, want, tstate, jstate = _decode_both(jcfg, jp, tcfg, tp, toks,
                                             prompt, cache_len=64)
    np.testing.assert_allclose(got, want, **TOL)
    ring = tstate["caches"]["layers"]
    assert tuple(ring["k"].shape) == (tcfg.num_layers, b, tcfg.num_kv_heads,
                                      16, tcfg.head_dim_eff)
    jring = jstate["caches"]["layers"]
    np.testing.assert_array_equal(ring["slot_pos"].numpy(),
                                  np.asarray(jring["slot_pos"]))
    assert sorted(ring["slot_pos"][0].tolist()) == list(range(16, 32))
    np.testing.assert_allclose(ring["k"].numpy(), np.asarray(jring["k"]),
                               rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        full = transformer.lm_forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got, full[:, prompt - 1:].numpy(), **TOL)


def test_ring_decode_from_a_short_prompt(danube):
    """A 5-token prefill that leaves the ring part empty, then 14 steps
    that wrap it one token at a time."""
    jcfg, jp, tcfg, tp = danube
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (1, 19)).astype(np.int32)
    got, want, tstate, _ = _decode_both(jcfg, jp, tcfg, tp, toks, 5,
                                        cache_len=24)
    np.testing.assert_allclose(got, want, **TOL)
    assert tstate["caches"]["layers"]["slot_pos"][0].tolist() == [
        16, 17, 18, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def test_ring_segments_cover_a_wrap():
    assert attention._ring_segments(14, 5, 16) == [(14, 0, 2), (0, 2, 3)]
    assert attention._ring_segments(3, 1, 16) == [(3, 0, 1)]
    assert attention._ring_segments(16, 16, 16) == [(0, 0, 16)]


@pytest.mark.parametrize("arch", ["gemma-2b", "internvl2-1b",
                                  "starcoder2-7b"])
def test_dense_cache_decode_matches_reference(arch):
    jcfg, jp, tcfg, tp = _pair(arch)
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 11)).astype(np.int32)
    got, want, _, _ = _decode_both(jcfg, jp, tcfg, tp, toks, 7, cache_len=16)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", [DANUBE, "qwen2-7b", "starcoder2-7b"])
def test_generate_batch_tokens_equal_reference_engine(arch):
    """Both engines serve the same 2 requests (6-token prompts, 14 new
    tokens: danube's 16-slot ring wraps): greedy tokens identical; the
    prefill and serve step builders give the engine's first tokens."""
    jcfg, jp, tcfg, tp = _pair(arch)
    jeng = JServeEngine(jcfg, jp, max_batch=2)
    teng = ServeEngine(tcfg, tp, max_batch=2, device="cpu")
    outs = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        rng = np.random.default_rng(5)
        reqs = [req(rng.integers(0, tcfg.vocab_size, 6).astype(np.int32),
                    max_new_tokens=14) for _ in range(2)]
        outs.append(eng.generate_batch(reqs))
    for jc, tc in zip(*outs):
        assert len(tc.tokens) == 14 and tc.steps == jc.steps
        np.testing.assert_array_equal(tc.tokens, jc.tokens)
    model = get_model(tcfg)
    prompts = torch.from_numpy(np.stack(
        [np.random.default_rng(5).integers(0, tcfg.vocab_size, 6)
         .astype(np.int32)] * 1))
    with torch.inference_mode():
        state = model.decode_init(1, 32, device="cpu")
        nxt, state = make_prefill_step(model)(tp, prompts, state)
        nxt2, state = make_serve_step(model)(tp, nxt, state)
    assert nxt.dtype == torch.int32 and nxt.shape == (1, 1)
    assert [int(nxt), int(nxt2)] == outs[1][0].tokens[:2].tolist()


def test_k4_is_never_called_on_decoder_paths(danube, monkeypatch):
    """With attn_impl="pallas" the reference sends nothing to K4 here: every
    training forward and ring or dense decode step sets ``q_pos`` (or
    ``kv_len``), so all attention runs ``mha_ref``."""
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    for arch in (DANUBE, "gemma-2b"):
        cfg = dataclasses.replace(configs.get_config(arch).reduced(),
                                  attn_impl="pallas")
        model = get_model(cfg)
        params = model.init(0, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 20),
                             generator=torch.Generator().manual_seed(0))
        value_and_grad(model.loss, params, {"tokens": toks})
        eng = ServeEngine(cfg, params, max_batch=2, device="cpu")
        eng.generate_batch([Request(toks[i, :6].numpy(), max_new_tokens=12)
                            for i in range(2)])
    assert calls == []
