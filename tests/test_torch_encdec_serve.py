"""The port's LM serving slice against the reference: the reduced
``seamless-m4t-medium`` (f32, ``attn_impl="pallas"``) with the reference's
own parameters (``params_from_numpy``) through ``encode``,
``prefill_encoder``, ``decode_step`` and ``ServeEngine.generate_batch``;
which attention calls reach the K4 op; and the configs of all ten archs.

Tolerances: encoder outputs and cross K/V rtol = atol = 1e-5 (the same f32
matmuls, summed in other orders by XLA and by PyTorch's CPU kernels);
logits rtol 1e-4, atol 1e-5 (twelve more layers of the same); greedy
tokens exactly.
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402

ARCH = "seamless-m4t-medium"


def _cfgs(impl="pallas"):
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(),
                               attn_impl=impl)
    tcfg = dataclasses.replace(configs.get_config(ARCH).reduced(),
                               attn_impl=impl)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def both():
    """(jax cfg, jax params, port cfg, port params): the reference's random
    parameters, carried over."""
    jcfg, tcfg = _cfgs()
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _frames(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _np(t):
    return t.detach().float().numpy()


def test_params_carry_over_unchanged(both):
    _, jparams, _, tparams = both
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_params_from_numpy_types():
    """bfloat16 numpy leaves become torch.bfloat16; ``dtype`` casts every
    floating leaf but the norm scales, which stay float32."""
    tree = {"final_norm": np.ones(4, np.float32),
            "dec": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                    "b16": np.asarray(jnp.ones(3, jnp.bfloat16))}}
    kept = params_from_numpy(tree, device="cpu")
    assert kept["dec"]["b16"].dtype == torch.bfloat16
    assert kept["dec"]["w"].dtype == torch.float32
    cast = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert cast["dec"]["w"].dtype == torch.bfloat16
    assert cast["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(cast["dec"]["w"].float().numpy(),
                                  tree["dec"]["w"])


def test_encode_and_prefill_encoder_match(both):
    jcfg, jparams, tcfg, tparams = both
    frames = _frames(1, 2, 6, tcfg.d_model)
    want = jencdec.encode(jparams, jcfg, jnp.asarray(frames))
    got = encdec.encode(tparams, tcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jcross = jencdec.prefill_encoder(jparams, jcfg, jnp.asarray(frames))
    tcross = encdec.prefill_encoder(tparams, tcfg, torch.from_numpy(frames))
    for name in ("k", "v"):
        assert tuple(tcross[name].shape) == jcross[name].shape
        assert tcross[name].is_contiguous()
        np.testing.assert_allclose(_np(tcross[name]),
                                   np.asarray(jcross[name]), rtol=1e-5,
                                   atol=1e-5)


def test_decode_step_logits_match(both):
    """Prefill of 5 prompt tokens, then four teacher-forced single-token
    steps (the same tokens into both), logits compared at every step."""
    jcfg, jparams, tcfg, tparams = both
    b, s_enc, s, cache_len = 2, 6, 5, 16
    rng = np.random.default_rng(2)
    frames = _frames(3, b, s_enc, tcfg.d_model)
    toks = rng.integers(0, tcfg.vocab_size, (b, s + 4)).astype(np.int32)
    jstate = jencdec.init_decode_state(jcfg, b, cache_len, s_enc)
    jstate["cross"] = jencdec.prefill_encoder(jparams, jcfg,
                                              jnp.asarray(frames))
    tstate = encdec.init_decode_state(tcfg, b, cache_len, s_enc,
                                      device="cpu")
    tstate["cross"] = encdec.prefill_encoder(tparams, tcfg,
                                             torch.from_numpy(frames))
    feeds = [toks[:, :s]] + [toks[:, i:i + 1] for i in range(s, s + 4)]
    for step, feed in enumerate(feeds):
        jlog, jstate = jencdec.decode_step(jparams, jcfg, jnp.asarray(feed),
                                           jstate)
        tlog, tstate = encdec.decode_step(tparams, tcfg,
                                          torch.from_numpy(feed), tstate)
        assert tstate["pos"] == int(jstate["pos"])
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {step}")
    np.testing.assert_allclose(_np(tstate["caches"]["k"]),
                               np.asarray(jstate["caches"]["k"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_generate_batch_tokens_equal_reference_engine(impl):
    """``test_serve.py::test_encdec_serving``'s inputs through both
    engines: the greedy tokens are identical."""
    jcfg, tcfg = _cfgs(impl)
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    jeng = JServeEngine(jcfg, jparams, max_batch=2)
    teng = ServeEngine(tcfg, tparams, max_batch=2, device="cpu")
    outs = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        rng = np.random.default_rng(4)
        frames = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
        reqs = [req(rng.integers(0, 64, 5).astype(np.int32),
                    max_new_tokens=4) for _ in range(2)]
        outs.append(eng.generate_batch(reqs, frame_embeds=frames))
    for jc, tc in zip(*outs):
        assert len(tc.tokens) == 4 and tc.steps == jc.steps
        np.testing.assert_array_equal(tc.tokens, jc.tokens)


def test_serve_batches_in_rounds_and_keeps_order(both):
    """``serve`` cuts 4 equal-length requests into 2 batches of
    ``max_batch``; each completion is the one its batch alone gives."""
    _, _, tcfg, tparams = both
    eng = ServeEngine(tcfg, tparams, max_batch=2, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(rng.integers(0, 64, 4).astype(np.int32),
                    max_new_tokens=3) for _ in range(4)]
    frames = _frames(6, 2, 5, tcfg.d_model)
    comps = eng.serve(reqs, frame_embeds=frames)
    for lo in (0, 2):
        alone = eng.generate_batch(reqs[lo:lo + 2], frame_embeds=frames)
        for got, want in zip(comps[lo:lo + 2], alone):
            np.testing.assert_array_equal(got.tokens, want.tokens)


def test_temperature_sampling_follows_the_engines_generator(both):
    """temperature > 0 draws from the engine's own generator: the same
    seed gives the same tokens, another seed other tokens, every token lies
    in the vocabulary, and a temperature near 0 gives the greedy tokens."""
    _, _, tcfg, tparams = both
    rng = np.random.default_rng(7)
    reqs = [Request(rng.integers(0, 64, 4).astype(np.int32),
                    max_new_tokens=6) for _ in range(2)]
    frames = _frames(8, 2, 5, tcfg.d_model)

    def tokens(seed, temperature):
        eng = ServeEngine(tcfg, tparams, max_batch=2, rng_seed=seed,
                          temperature=temperature, device="cpu")
        return np.stack([c.tokens for c in
                         eng.generate_batch(reqs, frame_embeds=frames)])

    first, again, other = tokens(1, 1.0), tokens(1, 1.0), tokens(2, 1.0)
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)
    for t in (first, other):
        assert t.shape == (2, 6)
        assert ((t >= 0) & (t < tcfg.vocab_size)).all()
    np.testing.assert_array_equal(tokens(3, 1e-4), tokens(0, 0.0))


def test_k4_dispatch_only_in_single_token_cross_attention(both, monkeypatch):
    """With attn_impl="pallas", the prefill (self- and cross-attention over
    the prompt) and every self-attention never call the K4 op; each
    single-token decode step calls it once per decoder layer, always as
    non-causal attention of one query over the encoder's keys."""
    _, _, tcfg, tparams = both
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    b, s_enc = 2, 7
    frames = _frames(7, b, s_enc, tcfg.d_model)
    state = encdec.init_decode_state(tcfg, b, 16, s_enc, device="cpu")
    enc = encdec.encode(tparams, tcfg, torch.from_numpy(frames))
    assert calls == []
    state["cross"] = encdec.prefill_encoder(tparams, tcfg,
                                            torch.from_numpy(frames))
    toks = torch.zeros((b, 5), dtype=torch.int32)
    _, state = encdec.decode_step(tparams, tcfg, toks, state)
    assert calls == [] and enc.shape == (b, s_enc, tcfg.d_model)
    for step in range(3):
        _, state = encdec.decode_step(tparams, tcfg, toks[:, :1], state)
        assert len(calls) == tcfg.num_layers * (step + 1)
    dh = tcfg.head_dim_eff
    assert all(c == ((b, tcfg.num_heads, 1, dh),
                     (b, tcfg.num_kv_heads, s_enc, dh),
                     {"causal": False, "window": None}) for c in calls)
    ref_cfg = dataclasses.replace(tcfg, attn_impl="reference")
    _, state = encdec.decode_step(tparams, ref_cfg, toks[:, :1], state)
    assert len(calls) == 3 * tcfg.num_layers


@pytest.mark.parametrize("name", jconfigs.list_archs())
def test_configs_equal_reference(name):
    j, t = jconfigs.get_config(name), configs.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.head_dim_eff == j.head_dim_eff


def test_config_registry_equal_reference():
    assert configs.list_archs() == jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("name", ["arctic-480b", "deepseek-v2-236b"])
def test_moe_families_give_the_reference_api(name):
    """``get_model`` of the MoE configs: the reference's ``ModelAPI``
    members, and a decode state whose leaves have the reference's shapes
    and dtypes (MLA's compressed cache for deepseek; ``pos`` a Python
    int)."""
    jcfg, tcfg = jconfigs.get_config(name).reduced(), \
        configs.get_config(name).reduced()
    jm, tm = jget_model(jcfg), get_model(tcfg)
    members = [f.name for f in dataclasses.fields(jm)]
    assert [f.name for f in dataclasses.fields(tm)] == members
    assert all(getattr(tm, m) is not None for m in members)
    jstate = jm.decode_init(2, 12)
    tstate = tm.decode_init(2, 12, device="cpu")
    assert tstate["pos"] == 0 and isinstance(tstate["pos"], int)
    want = [(x.shape, str(x.dtype))
            for x in jax.tree_util.tree_leaves(jstate["caches"])]
    from repro_torch.models.scan_util import tree_leaves
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
           for t in tree_leaves(tstate["caches"])]
    assert got == want and tstate["caches"].keys() == jstate["caches"].keys()


@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-2.7b"])
def test_recurrent_families_give_the_reference_api(name):
    """``get_model`` of the xLSTM and hybrid configs: the reference's
    ``ModelAPI`` members (``prefill`` included), and a decode state of the
    reference's structure and shapes (``decode_init`` called as the
    reference's serving engine calls it; ``pos`` a Python int)."""
    jcfg, tcfg = jconfigs.get_config(name).reduced(), \
        configs.get_config(name).reduced()
    jm, tm = jget_model(jcfg), get_model(tcfg)
    members = [f.name for f in dataclasses.fields(jm)]
    assert [f.name for f in dataclasses.fields(tm)] == members
    assert all(getattr(tm, m) is not None for m in members)
    if tcfg.xlstm is not None:
        jstate = jm.decode_init(2)
        tstate = tm.decode_init(2, device="cpu")
        assert tm.decode_init(2, 99, device="cpu").keys() == tstate.keys()
    else:
        jstate = jm.decode_init(2, 12)
        tstate = tm.decode_init(2, 12, device="cpu")
    assert tstate["pos"] == 0 and isinstance(tstate["pos"], int)
    want = jax.tree_util.tree_map(
        np.shape, {k: v for k, v in jstate.items() if k != "pos"})
    got = {k: v for k, v in tstate.items() if k != "pos"}
    from repro_torch.models.scan_util import tree_leaves, tree_map
    assert tree_map(lambda t: tuple(t.shape), got) == want
    assert all(t.dtype == torch.float32 or t.dtype == torch.bfloat16
               for t in tree_leaves(got))


@pytest.mark.parametrize("part", ["mla", "moe_block"])
def test_mla_and_the_moe_block_init_like_the_reference(part):
    """MLA attention and the MoE block kind, once refused, now init with
    the reference's keys, shapes and dtypes (reduced deepseek, bf16)."""
    from repro.models import attention as jattention
    from repro.models import transformer as jtransformer
    from repro_torch.models import attention, transformer
    from repro_torch.models.common import make_generator
    from repro_torch.models.scan_util import tree_leaves
    jcfg = dataclasses.replace(
        jconfigs.get_config("deepseek-v2-236b").reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(
        configs.get_config("deepseek-v2-236b").reduced(), dtype="bfloat16")
    gen = make_generator(0, "cpu")
    if part == "mla":
        want = jax.eval_shape(lambda k: jattention.init_attn(k, jcfg),
                              jax.random.PRNGKey(0))
        got = attention.init_attn(gen, tcfg)
    else:
        want = jax.eval_shape(lambda k: jtransformer.init_block(k, jcfg,
                                                                "moe"),
                              jax.random.PRNGKey(0))
        got = transformer.init_block(gen, tcfg, "moe")
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(got)] == [
        (x.shape, str(x.dtype)) for x in jax.tree_util.tree_leaves(want)]


def test_entry_points_default_to_the_card(both):
    """Without a card, the LM init, params_from_numpy and ServeEngine
    raise unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    _, _, tcfg, tparams = both
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(tcfg).init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tcfg, tparams)
    params = get_model(tcfg).init(0, device="cpu")
    assert params["decoder"]["xattn"]["wq"].shape == (
        tcfg.num_layers, tcfg.d_model, tcfg.num_heads * tcfg.head_dim_eff)


def test_port_init_matches_reference_layout_and_scale(both):
    """Same keys, shapes and dtypes as the reference's init; the draws are
    the same distributions (std 0.02 for embeddings, fan-in^-1/2 for
    dense weights, zeros for norms)."""
    _, jparams, tcfg, _ = both
    tparams = get_model(tcfg).init(3, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat:
        node = tparams
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype)
    assert torch.count_nonzero(tparams["final_norm"]) == 0
    assert abs(float(tparams["embed_in"].std()) - 0.02) < 2e-3
    wq = tparams["encoder"]["attn"]["wq"]
    assert abs(float(wq.std()) - tcfg.d_model ** -0.5) < 0.01
