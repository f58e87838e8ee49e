"""The port's LM training slice against the reference: the loss and its
gradients for the enc-dec and the dense / VLM decoder-only families,
``make_train_step`` with and without gradient accumulation, AdamW and
clipping over nested trees, the unbind layer loop, ``train_loop`` and its
resume.

Every model runs at the reduced config (f32, 4 layers, d_model 64) with the
reference's own random parameters (``params_from_numpy``) and batches drawn
from numpy seeds.  The JAX side of each case compiles once (``jax.jit``).

Tolerances (f32; XLA and PyTorch's CPU kernels sum the same matmuls in other
orders): losses rtol 1e-5; gradients rtol 1e-4, atol 5e-6 (largest
gradient about 0.5); after three AdamW steps (lr 1e-3) losses rtol 1e-5 and
parameters atol 1e-4, a tenth of one step (AdamW divides each gradient
element by its own magnitude, so an element whose gradient is near zero
moves by up to lr either way).  The optimizer alone on the same gradients
within rtol 1e-6 in f32 (XLA fuses the update's element-wise arithmetic;
the last bit may differ) and one bf16 ulp in bf16; the two layer-loop forms
bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro.models.lm import make_batch as jmake_batch  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import (add_accum_dim, make_train_step,  # noqa: E402
                                      value_and_grad)
from repro_torch.models import scan_util  # noqa: E402
from repro_torch.models.common import chunked_unembed_ce, cross_entropy  # noqa: E402
from repro_torch.models.lm import get_model, make_batch  # noqa: E402
from repro_torch.models.lm_params import (adam_state_from_numpy,  # noqa: E402
                                          params_from_numpy)
from repro_torch.models.scan_util import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

DENSE = ("gemma-2b", "qwen2-7b", "starcoder2-7b", "h2o-danube-3-4b",
         "internvl2-1b")
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=5e-6)
PARAM_TOL = dict(rtol=0, atol=1e-4)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(configs.get_config(arch).reduced(), **kw))


@pytest.fixture(scope="module")
def ref_params():
    """arch -> (reference params, the same as numpy): one init per arch."""
    out = {}
    for arch in ("seamless-m4t-medium",) + DENSE:
        jcfg, _ = _cfgs(arch)
        jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
        out[arch] = (jp, jax.tree_util.tree_map(np.asarray, jp))
    return out


def _batch(cfg, b, seq_len, seed):
    """numpy batch of the family's layout (lm.make_batch's shapes)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder_layers > 0:
        s_enc = seq_len // 4
        out["frame_embeds"] = rng.standard_normal(
            (b, s_enc, cfg.d_model)).astype(np.float32)
        seq_len -= s_enc
    elif cfg.frontend == "vision":
        p = min(cfg.frontend_tokens, seq_len - 1)
        out["patch_embeds"] = rng.standard_normal(
            (b, p, cfg.d_model)).astype(np.float32)
        seq_len -= p
    out["tokens"] = rng.integers(0, cfg.vocab_size, (b, seq_len)
                                 ).astype(np.int32)
    return out


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_trees_close(tleaves, jtree, **tol):
    jleaves = jax.tree_util.tree_leaves(jtree)
    assert len(tleaves) == len(jleaves)
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                                   err_msg=f"leaf {i}", **tol)


LOSS_CASES = [
    ("seamless-m4t-medium", {}),
    ("seamless-m4t-medium", {"remat": True}),
    ("gemma-2b", {}),
    ("gemma-2b", {"chunked_ce": 8}),
    ("gemma-2b", {"bf16_grad_stream": True}),
    ("gemma-2b", {"remat": True}),
    ("qwen2-7b", {}),
    ("starcoder2-7b", {}),
    ("h2o-danube-3-4b", {}),
    ("internvl2-1b", {}),
    ("internvl2-1b", {"chunked_ce": 8, "remat": True}),
]


@pytest.mark.parametrize("arch,kw", LOSS_CASES,
                         ids=[f"{a}-{'-'.join(k) or 'plain'}"
                              for a, k in LOSS_CASES])
def test_loss_and_grads_match_reference(ref_params, arch, kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, np_params = ref_params[arch]
    batch = _batch(tcfg, 2, 24 if tcfg.frontend == "vision" else 16, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jget_model(jcfg).loss))(
        jp, _jnp(batch))
    tparams = params_from_numpy(np_params, device="cpu")
    tloss, tgrads = value_and_grad(get_model(tcfg).loss, tparams,
                                   _tensors(batch))
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _assert_trees_close(tree_leaves(tgrads), jgrads, **GRAD_TOL)
    assert not any(p.requires_grad for p in tree_leaves(tparams))


def test_chunked_ce_equals_plain_ce_and_checks_the_chunk():
    """The block loop gives the plain CE over [B,S,V] logits, with and
    without autograd; a chunk that does not divide S is refused."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 12, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 33)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 33, (2, 12)))
    mask = torch.ones((2, 12))
    mask[:, -1] = 0
    want = cross_entropy((h @ w)[:, :-1], labels[:, :-1])
    with torch.no_grad():
        got = chunked_unembed_ce(h, w, labels, mask, 4)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="multiple"):
        chunked_unembed_ce(h, w, labels, mask, 5)


def test_layer_norm_and_grad_cast_match_reference():
    """``layer_norm`` against the reference's (f32, rtol 1e-6; in bf16 one
    ulp); ``grad_cast`` is the identity forward and hands back a gradient
    of the forward's dtype."""
    from repro.models import common as jcommon
    from repro_torch.models import common
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3 + 1
    sc, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    want = np.asarray(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(sc),
                                         jnp.asarray(b)))
    got = common.layer_norm(torch.from_numpy(x), torch.from_numpy(sc),
                            torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want16 = jcommon.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(sc),
                                jnp.asarray(b))
    got16 = common.layer_norm(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(sc), torch.from_numpy(b))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32), rtol=2 ** -7,
                               atol=1e-6)
    h = torch.from_numpy(x).bfloat16().requires_grad_(True)
    out = common.grad_cast(h)
    assert torch.equal(out, h)
    (g,) = torch.autograd.grad((out.float() * 2).sum(), h)
    assert g.dtype == torch.bfloat16 and bool((g == 2).all())


# ---------------------------------------------------------------------------
# train steps, AdamW, clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum", [("gemma-2b", 1), ("gemma-2b", 2),
                                        ("seamless-m4t-medium", 2),
                                        ("internvl2-1b", 1)])
def test_train_step_matches_reference(ref_params, arch, accum):
    """Three ``make_train_step`` steps (lr 1e-3, clip 1.0) from the same
    parameters and batches: losses and updated parameters."""
    jcfg, tcfg = _cfgs(arch, grad_accum=accum)
    jp, np_params = ref_params[arch]
    acfg = dict(lr=1e-3, clip_norm=1.0)
    jopt = jadam.AdamW(jadam.AdamConfig(**acfg))
    topt = adam.AdamW(adam.AdamConfig(**acfg))
    jstep = jax.jit(jmake_train_step(jget_model(jcfg), jopt))
    tstep = make_train_step(get_model(tcfg), topt)
    jstate = jopt.init(jp)
    tparams = params_from_numpy(np_params, device="cpu")
    tstate = topt.init(tparams)
    seq = 24 if tcfg.frontend == "vision" else 16
    for step in range(3):
        batch = add_accum_dim(tcfg, _batch(tcfg, 4, seq, seed=10 + step))
        jp, jstate, jloss = jstep(jp, jstate, _jnp(batch))
        tparams, tstate, tloss = tstep(tparams, tstate, _tensors(batch))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
    assert tstate["step"] == int(jstate["step"]) == 3
    _assert_trees_close(tree_leaves(tparams), jp, **PARAM_TOL)


def test_add_accum_dim_splits_the_batch():
    _, tcfg = _cfgs("gemma-2b", grad_accum=2)
    got = add_accum_dim(tcfg, {"tokens": torch.arange(12).reshape(4, 3)})
    assert got["tokens"].shape == (2, 2, 3)
    assert got["tokens"][1, 0].tolist() == [6, 7, 8]
    with pytest.raises(ValueError, match="grad_accum"):
        add_accum_dim(tcfg, {"tokens": np.zeros((3, 2))})


def _nested(rng, dtype):
    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"emb": leaf(5, 3), "stack": {"w": leaf(2, 3, 4), "b": leaf(2, 4)},
            "groups": [{"z": leaf(3)}, {"a": leaf(2, 2), "y": leaf(1)}]}
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), tree)


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_adamw_and_clipping_on_nested_trees(dtype, moments):
    """Four AdamW updates (clip 0.5, weight decay) of a nested tree of
    dicts and lists against the reference's, on the same gradients: f32
    parameters and moments within rtol 1e-6; bf16 parameters with bf16
    moments (``moment_dtype`` honoured) within one bf16 ulp.  Clipping
    alone: the norm and the clipped leaves (f32, as the reference's)."""
    rng = np.random.default_rng(4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    params = _nested(rng, np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jopt = jadam.AdamW(jadam.AdamConfig(lr=1e-2, clip_norm=0.5,
                                        weight_decay=0.01,
                                        moment_dtype=getattr(jnp, moments)))
    topt = adam.AdamW(adam.AdamConfig(lr=1e-2, clip_norm=0.5,
                                      weight_decay=0.01,
                                      moment_dtype=getattr(torch, moments)))
    jstate, tstate = jopt.init(jp), topt.init(tp)
    assert all(m.dtype == getattr(torch, moments)
               for m in tree_leaves(tstate["m"]))
    for _ in range(4):
        g = _nested(rng, np.float32)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g)
        tg = params_from_numpy(jax.tree_util.tree_map(np.asarray, jg),
                               device="cpu")
        jp, jstate = jopt.update(jg, jstate, jp)
        tp, tstate = topt.update(tg, tstate, tp)
    tol = (dict(rtol=1e-6, atol=1e-9) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=1e-6))
    for t_tree, j_tree in ((tp, jp), (tstate["m"], jstate["m"]),
                           (tstate["v"], jstate["v"])):
        _assert_trees_close(tree_leaves(t_tree), j_tree, **tol)
        assert all(str(t.dtype) == f"torch.{j.dtype}" for t, j in zip(
            tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)))
    clipped, norm = adam.clip_by_global_norm(tg, 0.5)
    jclipped, jnorm = jadam.clip_by_global_norm(jg, 0.5)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert all(t.dtype == torch.float32 for t in tree_leaves(clipped))
    _assert_trees_close(tree_leaves(clipped), jclipped, rtol=1e-6, atol=0)


def test_tree_order_is_jax_flatten_order():
    """Dict keys sorted, lists in order — GraphSAGE's ``{"layers":
    [{"w", "b"}]}`` gives b before w in each layer, as before."""
    rng = np.random.default_rng(5)
    tree = _nested(rng, np.float32)
    tree["layers"] = [{"w": rng.normal(size=2), "b": rng.normal(size=1)}]
    ours = [np.asarray(x) for x in tree_leaves(tree)]
    theirs = jax.tree_util.tree_leaves(tree)
    assert len(ours) == len(theirs)
    assert all(a is b or np.array_equal(a, b) for a, b in zip(ours, theirs))
    gs = {"layers": [{"w": 1, "b": 2}, {"w": 3, "b": 4}]}
    assert tree_leaves(gs) == [2, 1, 4, 3]


def test_adam_state_from_numpy_on_a_nested_tree(ref_params):
    _, np_params = ref_params["gemma-2b"]
    jopt = jadam.AdamW()
    st = jax.tree_util.tree_map(np.asarray, jopt.init(
        jax.tree_util.tree_map(jnp.asarray, np_params)))
    got = adam_state_from_numpy(st, device="cpu")
    assert got["step"] == 0
    assert got["m"]["layers"]["attn"]["wq"].shape == \
        np_params["layers"]["attn"]["wq"].shape


# ---------------------------------------------------------------------------
# the layer loop
# ---------------------------------------------------------------------------

def test_unbind_loop_matches_the_view_loop_bit_for_bit():
    """``scan`` splits each stacked leaf with one ``torch.unbind``; its
    outputs and gradients equal those of the loop over ``leaf[i]`` views
    (the form serving had) bit for bit in f32, under autograd and under
    ``inference_mode``, where an in-place write through a layer reaches
    the stack (serving's cache writes); its backward is one stack per
    leaf, not a whole-stack zero tensor per layer."""
    rng = np.random.default_rng(6)
    stack = {"w": torch.from_numpy(rng.standard_normal((5, 8, 8)).astype(
        np.float32)), "n": {"s": torch.from_numpy(rng.standard_normal(
            (5, 8)).astype(np.float32))}}
    x0 = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))

    def body(h, bp):
        return torch.tanh(h @ bp["w"]) * (1 + bp["n"]["s"]), None

    def run(loop):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(stack)]
        tree = scan_util.tree_unflatten(stack, leaves)
        out = loop(tree)
        return out, torch.autograd.grad(out.square().sum(), leaves)

    def view_loop(tree):
        h = x0
        for i in range(tree_leaves(tree)[0].shape[0]):
            h, _ = body(h, scan_util.tree_map(lambda x: x[i], tree))
        return h

    out_u, g_u = run(lambda tree: scan_util.scan(body, x0, tree)[0])
    out_v, g_v = run(view_loop)
    assert torch.equal(out_u, out_v)
    assert all(torch.equal(a, b) for a, b in zip(g_u, g_v))
    out_r, g_r = run(lambda tree: scan_util.scan(body, x0, tree,
                                                 remat=True)[0])
    assert torch.equal(out_r, out_v)
    assert all(torch.equal(a, b) for a, b in zip(g_r, g_v))
    with torch.inference_mode():
        tree = scan_util.tree_map(torch.clone, stack)
        assert torch.equal(scan_util.scan(body, x0, tree)[0], view_loop(tree))

        def write(h, bp):
            bp["n"]["s"].fill_(0.5)
            return h, None
        scan_util.scan(write, x0, tree)
        assert bool((tree["n"]["s"] == 0.5).all())
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(stack)]
    out = scan_util.scan(body, x0, scan_util.tree_unflatten(stack, leaves))[0]
    assert out.grad_fn is not None
    names = set()
    todo = [out.grad_fn]
    while todo:
        fn = todo.pop()
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions if f is not None)
    assert any(n.startswith("UnbindBackward") for n in names)
    assert not any(n.startswith("SelectBackward") for n in names)


# ---------------------------------------------------------------------------
# train_loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("seamless-m4t-medium",) + DENSE)
def test_train_loop_matches_reference(ref_params, monkeypatch, arch):
    """Both packages' ``train_loop`` (2 steps, batch 2, seq 16 or 24; the
    token pipeline and the seeded stub frames or patches) from the
    reference's parameters: the same losses."""
    from repro.launch import train as jtrain_mod
    jcfg, tcfg = _cfgs(arch)
    jp, np_params = ref_params[arch]
    jmodel = dataclasses.replace(jget_model(jcfg), init=lambda key: jp)
    tmodel = dataclasses.replace(get_model(tcfg), init=lambda seed=0, device=None: (
        params_from_numpy(np_params, device=device)))
    monkeypatch.setattr(jtrain_mod, "get_model", lambda cfg: jmodel)
    monkeypatch.setattr(train_mod, "get_model", lambda cfg: tmodel)
    kw = dict(steps=2, batch=2, seq_len=24 if tcfg.frontend == "vision"
              else 16, lr=1e-3, log_every=0)
    want = jtrain_mod.train_loop(jcfg, **kw)
    got = train_mod.train_loop(tcfg, device="cpu", **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
    assert len(got.step_times) == 2 and got.resumed_from == 0


def test_train_loop_resumes_a_bf16_run(tmp_path):
    """A bf16 reduced gemma run of 4 steps against 3 steps, then a resume
    to 4 from the step-2 checkpoint: the resumed steps' losses equal the
    uninterrupted run's (one CPU thread: bits vary with the thread
    count)."""
    cfg = dataclasses.replace(configs.get_config("gemma-2b").reduced(),
                              dtype="bfloat16")
    kw = dict(batch=2, seq_len=16, ckpt_every=2, log_every=0, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full = train_mod.train_loop(cfg, steps=4, ckpt_dir=tmp_path / "a",
                                    **kw)
        cut = train_mod.train_loop(cfg, steps=3, ckpt_dir=tmp_path / "b",
                                   **kw)
        resumed = train_mod.train_loop(cfg, steps=4, ckpt_dir=tmp_path / "b",
                                       resume=True, **kw)
    finally:
        torch.set_num_threads(threads)
    assert full.checkpoints == 2 and cut.checkpoints == 1
    assert resumed.resumed_from == 2 and resumed.checkpoints == 1
    assert cut.losses == full.losses[:3]
    assert resumed.losses == full.losses[2:]
    assert all(np.isfinite(full.losses))


def test_train_loop_refuses_a_mesh_and_defaults_to_the_card():
    """On a mesh, ``train_loop`` refuses what it does not run before any
    rank work (a duck-typed mesh suffices): a batch the data axis does not
    split (every family now trains on a model axis:
    ``tests/test_torch_lm_mesh_tp.py``); without a card it does not fall
    back to the CPU."""
    _, tcfg = _cfgs("gemma-2b")

    def mesh(data, model):
        return type("M", (), {"axis_names": ("data", "model"),
                              "shape": {"data": data, "model": model}})()
    with pytest.raises(ValueError, match="3 data ranks"):
        train_mod.train_loop(tcfg, steps=1, batch=2, seq_len=8,
                             mesh=mesh(3, 1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_mod.train_loop(tcfg, steps=1, batch=2, seq_len=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_batch(tcfg, 8, 2)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b",
                                  "gemma-2b"])
def test_make_batch_layouts(arch):
    """``make_batch`` draws the reference's layout from a torch.Generator
    on the given device, the same for the same seed."""
    jcfg, tcfg = _cfgs(arch)
    want = jax.tree_util.tree_map(np.shape, jmake_batch(jcfg, 32, 3))
    got = make_batch(tcfg, 32, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert got["tokens"].dtype == torch.int32
    assert int(got["tokens"].max()) < tcfg.vocab_size
    again = make_batch(tcfg, 32, 3, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_main_runs_the_reduced_cli(tmp_path, capsys):
    train_mod.main(["--arch", "seamless-m4t-medium", "--reduced", "--steps",
                    "3", "--batch", "2", "--seq-len", "16", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and "step 0" in out


def test_pretrain_example_checkpoints_and_resumes(tmp_path):
    """``examples/lm_pretrain_torch.py`` on the CPU: 6 steps of the
    reduced gemma (f32) with a checkpoint every 3, then a resume to 8."""
    repo = Path(__file__).resolve().parents[1]

    def run(*args):
        proc = subprocess.run(
            [sys.executable, str(repo / "examples" / "lm_pretrain_torch.py"),
             "--arch", "gemma-2b", "--reduced", "--batch", "2",
             "--seq-len", "16", "--device", "cpu", "--ckpt-dir",
             str(tmp_path), "--ckpt-every", "3", *args],
            env=dict(os.environ, PYTHONPATH=str(repo / "src")),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    assert "(6 steps, resumed from 0)" in run("--steps", "6")
    out = run("--steps", "8", "--resume")
    assert "(2 steps, resumed from 6)" in out
    assert "checkpoints written: 0" in out
