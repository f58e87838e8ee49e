"""The port's recurrent LM families against the reference: the hybrid
Mamba2 + shared-attention model (zamba2-2.7b), its pure-SSM variant
(``shared_attn_every=0``) and xLSTM (xlstm-125m), at their reduced configs
(f32): the layer plans, the loss and every gradient, decode over a prompt
and then single tokens, ``ServeEngine``, ``train_loop`` and its resume,
that every decode state is a tensor of its own, and
``params_from_numpy``'s f32 leaves.

Inputs come from numpy seeds, parameters are the reference's own
(``params_from_numpy``).  Tolerances (f32; XLA and PyTorch's CPU kernels
sum the same products in other orders): losses rtol 1e-5; gradients rtol
1e-4, atol 5e-6 (largest gradient about 0.5), xLSTM's atol 3e-5 (its tied
embedding's largest gradient is 1.9, and there both packages' f32
gradients sit up to 4.7e-5 (port) and 2.3e-5 (reference) from an f64
evaluation of the same loss: the exponential gates' conditioning, not a
difference of the ports); logits rtol 1e-4, atol 1e-5; greedy tokens and
resumed losses exactly.
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
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import xlstm_lm as jxlstm_lm  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import hybrid, xlstm_lm  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402
from repro_torch.models.scan_util import tree_leaves  # noqa: E402

XLSTM, ZAMBA = "xlstm-125m", "zamba2-2.7b"
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=5e-6)
XLSTM_GRAD_TOL = dict(rtol=1e-4, atol=3e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
VARIANTS = {                      # id -> (arch, config changes)
    "xlstm": (XLSTM, {}),
    "xlstm-remat": (XLSTM, {"remat": True}),
    "zamba2": (ZAMBA, {}),
    "zamba2-remat": (ZAMBA, {"remat": True}),
    "pure-ssm": (ZAMBA, {"shared_attn_every": 0}),
}


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(configs.get_config(arch).reduced(), **kw))


@pytest.fixture(scope="module")
def ref_params():
    """variant id -> (reference params, the same as numpy)."""
    out = {}
    for vid in ("xlstm", "zamba2", "pure-ssm"):
        arch, kw = VARIANTS[vid]
        jcfg, _ = _cfgs(arch, **kw)
        jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
        out[vid] = (jp, jax.tree_util.tree_map(np.asarray, jp))
    return out


def _params(ref_params, vid):
    return ref_params[vid.replace("-remat", "")]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# layer plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_layer_plans_equal_reference(reduced):
    for arch in (XLSTM, ZAMBA):
        j, t = jconfigs.get_config(arch), configs.get_config(arch)
        if reduced:
            j, t = j.reduced(), t.reduced()
        if arch == XLSTM:
            assert xlstm_lm.layer_runs(t) == jxlstm_lm.layer_runs(j)
        else:
            assert hybrid.group_dims(t) == jhybrid.group_dims(j)
            pure_j = dataclasses.replace(j, shared_attn_every=0)
            pure_t = dataclasses.replace(t, shared_attn_every=0)
            assert hybrid.group_dims(pure_t) == jhybrid.group_dims(pure_j)
    assert xlstm_lm.layer_runs(configs.get_config(XLSTM)) == [
        ("run0_mlstm", 3, "mlstm"), ("run1_slstm", 1, "slstm"),
        ("run2_mlstm", 5, "mlstm"), ("run3_slstm", 1, "slstm"),
        ("run4_mlstm", 2, "mlstm")]
    assert hybrid.group_dims(configs.get_config(ZAMBA)) == (9, 6)


@pytest.mark.parametrize("vid", ["xlstm", "zamba2", "pure-ssm"])
def test_init_matches_reference_layout(vid):
    """The port's own init: the reference's keys, shapes and dtypes, in
    f32 and in bf16 (where the SSD's decay, skip and step bias, the sLSTM
    gate biases and the norms stay f32)."""
    arch, kw = VARIANTS[vid]
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(arch, dtype=dtype, **kw)
        want = jax.tree_util.tree_map(
            lambda x: (x.shape, str(x.dtype)),
            jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0)))
        got = get_model(tcfg).init(0, device="cpu")
        shapes = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(
            x, tuple))
        leaves = tree_leaves(got)
        assert len(leaves) == len(shapes)
        for t, (shape, dt) in zip(leaves, shapes):
            assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == (shape, dt)


@pytest.mark.parametrize("vid", ["xlstm", "zamba2"])
def test_params_from_numpy_keeps_the_reference_f32_leaves(ref_params, vid):
    """Cast to bf16, the f32 reference tree keeps a_log, ssm_d, dt_bias,
    b_gates and the norm scales in f32, as the reference's bf16 init has
    them; every other floating leaf is bf16."""
    arch, kw = VARIANTS[vid]
    _, np_params = ref_params[vid]
    jcfg, _ = _cfgs(arch, dtype="bfloat16", **kw)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x: str(x.dtype),
        jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))))
    got = params_from_numpy(np_params, device="cpu", dtype=torch.bfloat16)
    assert [str(t.dtype).split(".")[-1] for t in tree_leaves(got)] == want
    assert "float32" in want and "bfloat16" in want


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vid", list(VARIANTS))
def test_loss_and_grads_match_reference(ref_params, vid):
    arch, kw = VARIANTS[vid]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, np_params = _params(ref_params, vid)
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
    tol = XLSTM_GRAD_TOL if arch == XLSTM else GRAD_TOL
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   err_msg=f"leaf {i}", **tol)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_both(jcfg, jp, tcfg, tp, toks, prompt, cache_len):
    """Prefill ``prompt`` tokens, then one teacher-forced token per step,
    through both packages' ``decode_step``; (port logits, reference
    logits, port state, reference state)."""
    jm, tm = jget_model(jcfg), get_model(tcfg)
    b = toks.shape[0]
    if tcfg.xlstm is not None:
        jstate = jm.decode_init(b)
        tstate = tm.decode_init(b, device="cpu")
    else:
        jstate = jm.decode_init(b, cache_len)
        tstate = tm.decode_init(b, cache_len, device="cpu")
    jstep = jax.jit(jm.decode_step)
    feeds = [toks[:, :prompt]] + [toks[:, i:i + 1]
                                  for i in range(prompt, toks.shape[1])]
    tl, jl = [], []
    with torch.inference_mode():
        for feed in feeds:
            logits, jstate = jstep(jp, jnp.asarray(feed), jstate)
            jl.append(np.asarray(logits))
            logits, tstate = tm.decode_step(tp, torch.from_numpy(feed),
                                            tstate)
            tl.append(logits.numpy())
            assert tstate["pos"] == int(jstate["pos"])
    return np.stack(tl, 1), np.stack(jl, 1), tstate, jstate


@pytest.mark.parametrize("vid", ["xlstm", "zamba2", "pure-ssm"])
def test_decode_matches_reference_and_parallel_forward(ref_params, vid):
    """A 9-token prompt, then 5 single tokens: logits against the
    reference's at every step and against the parallel forward over the
    same tokens (the reference's ``tests/test_arch_smoke.py`` check);
    the recurrent states and KV caches against the reference's."""
    arch, kw = VARIANTS[vid]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, np_params = ref_params[vid]
    tp = params_from_numpy(np_params, device="cpu")
    toks = _tokens(tcfg, 2, 14, seed=2)
    got, want, tstate, jstate = _decode_both(jcfg, jp, tcfg, tp, toks, 9,
                                             cache_len=20)
    np.testing.assert_allclose(got, want, **TOL)
    jl = jax.tree_util.tree_leaves({k: v for k, v in jstate.items()
                                    if k != "pos"})
    tl = tree_leaves({k: v for k, v in tstate.items() if k != "pos"})
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32),
                                   **TOL)
    fwd = (xlstm_lm.xlstm_forward if tcfg.xlstm is not None
           else hybrid.hybrid_forward)
    with torch.inference_mode():
        full = fwd(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got, full[:, 8:].numpy(), **TOL)


@pytest.mark.parametrize("vid", ["xlstm", "zamba2"])
def test_prefill_is_the_parallel_forward(ref_params, vid):
    """``prefill``: the parallel forward's last logits (the reference's
    prefill's, within TOL) and the state handed back unchanged."""
    arch, kw = VARIANTS[vid]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, np_params = ref_params[vid]
    tp = params_from_numpy(np_params, device="cpu")
    toks = _tokens(tcfg, 2, 12, seed=3)
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jstate = jm.decode_init(2) if tcfg.xlstm else jm.decode_init(2, 16)
    tstate = (tm.decode_init(2, device="cpu") if tcfg.xlstm
              else tm.decode_init(2, 16, device="cpu"))
    want, _ = jm.prefill(jp, jnp.asarray(toks), jstate)
    with torch.inference_mode():
        got, st = tm.prefill(tp, torch.from_numpy(toks), tstate)
    assert st is tstate and st["pos"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_states_are_tensors_of_their_own():
    """After one decode step every KV group, every Mamba2 layer's state and
    every xLSTM layer's state differs from the others: no state is a
    broadcast view (a reduced zamba2 with 9 shared-block groups)."""
    _, tcfg = _cfgs(ZAMBA, num_layers=18)
    assert hybrid.group_dims(tcfg) == (9, 2)
    m = get_model(tcfg)
    tp = m.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, 2, 5, seed=4))
    state = m.decode_init(2, 8, device="cpu")
    k = state["shared_kv"]["k"]
    assert tuple(k.shape)[0] == 9 and k.stride(0) > 0
    with torch.inference_mode():
        _, state = m.decode_step(tp, toks, state)
    k = state["shared_kv"]["k"][:, :, :, :5].flatten(1)
    assert all(not torch.equal(k[i], k[j]) for i in range(9)
               for j in range(i + 1, 9))
    for leaf in tree_leaves(state["mamba"]):
        flat = leaf.flatten(0, 1).flatten(1)
        assert len({tuple(r.tolist()) for r in flat}) == 18
    _, xcfg = _cfgs(XLSTM)
    xm = get_model(xcfg)
    xs = xm.decode_init(2, device="cpu")
    with torch.inference_mode():
        _, xs = xm.decode_step(xm.init(0, device="cpu"), toks, xs)
    for run in xs["states"].values():
        for leaf in tree_leaves(run):
            assert leaf.stride(0) > 0
            if leaf.shape[0] > 1:
                assert not torch.equal(leaf[0], leaf[1])


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vid", ["xlstm", "zamba2"])
def test_generate_batch_tokens_equal_reference_engine(ref_params, vid):
    """Both engines serve the same 3 requests (12-token prompts, 5 new
    tokens): greedy tokens identical and in the vocabulary."""
    arch, kw = VARIANTS[vid]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, np_params = ref_params[vid]
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


def test_serve_groups_mixed_lengths_like_the_reference(ref_params):
    jcfg, tcfg = _cfgs(XLSTM)
    jp, np_params = ref_params["xlstm"]
    tp = params_from_numpy(np_params, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, n).astype(np.int32)
               for n in (8, 12, 8, 12, 8)]
    want = JServeEngine(jcfg, jp, max_batch=2).serve(
        [JRequest(p, max_new_tokens=3) for p in prompts])
    got = ServeEngine(tcfg, tp, max_batch=2, device="cpu").serve(
        [Request(p, max_new_tokens=3) for p in prompts])
    assert all(c is not None and len(c.tokens) == 3 for c in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.parametrize("arch", [XLSTM, ZAMBA])
def test_eos_stops_slot(arch):
    _, tcfg = _cfgs(arch)
    eng = ServeEngine(tcfg, get_model(tcfg).init(0, device="cpu"),
                      max_batch=2, device="cpu")
    p = np.random.default_rng(3).integers(0, 64, 8).astype(np.int32)
    free = eng.generate_batch([Request(p, max_new_tokens=6)])[0]
    eos_id = int(free.tokens[1])
    comp = eng.generate_batch([Request(p, max_new_tokens=6,
                                       eos_id=eos_id)])[0]
    assert comp.tokens[-1] == eos_id
    assert len(comp.tokens) == list(free.tokens).index(eos_id) + 1


# ---------------------------------------------------------------------------
# train_loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vid", ["xlstm", "zamba2"])
def test_train_loop_matches_reference(ref_params, monkeypatch, vid):
    """Both packages' ``train_loop`` (3 steps, batch 2, seq 16, lr 1e-3)
    from the reference's parameters: the same losses."""
    from repro.launch import train as jtrain_mod
    arch, kw = VARIANTS[vid]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, np_params = ref_params[vid]
    jmodel = dataclasses.replace(jget_model(jcfg), init=lambda key: jp)
    tmodel = dataclasses.replace(
        get_model(tcfg), init=lambda seed=0, device=None: params_from_numpy(
            np_params, device=device))
    monkeypatch.setattr(jtrain_mod, "get_model", lambda cfg: jmodel)
    monkeypatch.setattr(train_mod, "get_model", lambda cfg: tmodel)
    kw = dict(steps=3, batch=2, seq_len=16, lr=1e-3, log_every=0)
    want = jtrain_mod.train_loop(jcfg, **kw)
    got = train_mod.train_loop(tcfg, device="cpu", **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)


def test_train_loop_resume_bitexact(tmp_path):
    """The reference's ``tests/test_checkpoint.py`` case on the port: 6
    steps against 4 (a checkpoint at step 3) and a resume to 6; the
    resumed losses equal the uninterrupted run's bit for bit (one CPU
    thread: bits vary with the thread count)."""
    _, tcfg = _cfgs(XLSTM)
    kw = dict(batch=4, seq_len=16, log_every=0, ckpt_every=3, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full = train_mod.train_loop(tcfg, steps=6, ckpt_dir=tmp_path / "a",
                                    **kw)
        train_mod.train_loop(tcfg, steps=4, ckpt_dir=tmp_path / "b", **kw)
        resumed = train_mod.train_loop(tcfg, steps=6, ckpt_dir=tmp_path / "b",
                                       resume=True, **kw)
    finally:
        torch.set_num_threads(threads)
    assert resumed.resumed_from == 3
    assert resumed.losses == full.losses[3:]
    assert all(np.isfinite(full.losses)) and full.losses[-1] < full.losses[0]


# ---------------------------------------------------------------------------
# the example twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_serve_example_runs_reduced_on_the_cpu(arch):
    """``examples/serve_lm_torch.py --reduced --device cpu``: every request
    of the mixed-length queue gets its tokens."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(repo / "examples" / "serve_lm_torch.py"),
         "--arch", arch, "--reduced", "--device", "cpu", "--requests", "5",
         "--max-new", "4"],
        env=dict(os.environ, PYTHONPATH=str(repo / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"arch={arch}" in proc.stdout and "device=cpu" in proc.stdout
    assert sum(line.startswith("req") for line in
               proc.stdout.splitlines()) == 5


# ---------------------------------------------------------------------------
# the recurrent prefill against the parallel forward at full width
# ---------------------------------------------------------------------------

def _prefill_gaps(dtype, s):
    """xlstm-125m at its published width in ``dtype``, the reference's
    parameters: max |decode_step over s prompt tokens - parallel forward|
    at the last position, (port, reference, largest logit)."""
    jcfg = dataclasses.replace(jconfigs.get_config(XLSTM), dtype=dtype)
    tcfg = dataclasses.replace(configs.get_config(XLSTM), dtype=dtype)
    jm, tm = jget_model(jcfg), get_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    toks = _tokens(tcfg, 1, s, seed=5)
    jl, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks), jm.decode_init(1))
    jf = jax.jit(lambda p, t: jxlstm_lm.xlstm_forward(p, jcfg, t)[:, -1])(
        jp, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = tm.decode_step(tp, torch.from_numpy(toks),
                               tm.decode_init(1, device="cpu"))
        tf = xlstm_lm.xlstm_forward(tp, tcfg, torch.from_numpy(toks))[:, -1]
    jgap = float(jnp.abs(jl.astype(jnp.float32)
                         - jf.astype(jnp.float32)).max())
    tgap = float((tl.float() - tf.float()).abs().max())
    return tgap, jgap, float(tf.float().abs().max())


def test_bf16_prefill_gap_is_the_references():
    """At the published width the recurrent prefill and the parallel
    forward part by a large share of the largest logit in bf16, in the
    reference as in the port (0.493 and 0.516 of 2.39 at 512 tokens: one
    bf16 ulp of an activation, amplified by the exponential gates), and
    agree in f32 (9.4e-4 and 1.9e-3 of 2.34, within 2^-5 of the largest
    logit, the check ``chip_smoke.py``'s ``lm-serve-rec`` makes on the
    card).  The port's bf16 gap stays within twice the reference's."""
    tgap, jgap, scale = _prefill_gaps("bfloat16", 512)
    assert jgap > 2.0 ** -5 * scale            # the reference's own gap
    assert tgap <= 2 * jgap
    tgap32, jgap32, scale32 = _prefill_gaps("float32", 512)
    assert max(tgap32, jgap32) <= 2.0 ** -5 * scale32
