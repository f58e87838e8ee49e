"""Serving the LM zoo on a mesh of gloo CPU ranks (``launch/serve.py::
mesh_generate``, ``launch/steps.py``'s serve and prefill steps with
``plans=`` and ``layout=``) against the reference's single-device decode
from the same weights.

The six reduced families of ``tests/test_dryrun_small.py`` decode a batch
of 2 prompts on (1, 2), (2, 1) and (2, 2): the greedy tokens equal, and
every step's logits and each rank's final state slices (its block of the
reference's state under the rules of ``launch/specs.py``) within
``ATOL`` + ``RTOL``·|ref| (f32; the same tolerances as
``tests/test_torch_decoder_lm.py``'s single-device serving: the xLSTM's
matrix memory ``c``, values near 0.6, differs from the reference's by up
to 1.3e-5, 2.3e-5 of its size; every logit is within 1e-5).  At B=1 on
(2, 1) the caches split their slots over the data axis: danube's ring,
deepseek's MLA latent, qwen2's dense cache and seamless's cross K/V.
``prefill_step``, and one ``serve_step`` after it, give the reference's
next tokens on every mesh.

The MoE layer routes each data rank's tokens on its own when it runs
expert-parallel (deepseek on (2, 2)), as the reference's sharded program
does (``tests/test_torch_lm_mesh_moe.py``): there the reference decodes
each data rank's rows as a batch of its own.

deepseek also decodes on (1, 3), a model axis that divides neither its 4
experts nor its 4 heads: every rank runs the MoE layer's single-device
branch and MLA over all heads (``q_up`` a column block gathered whole,
``k_up`` / ``v_up`` / ``wo`` whole), its latent cache whole; the same
tokens, logits and state as the reference's single-device decode.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import make_prefill_step as jprefill  # noqa: E402
from repro.launch.steps import make_serve_step as jserve  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.sharding import (ShardPlan, map_with_path,  # noqa: E402
                                        spec_for)
from repro_torch.launch.specs import state_shardings  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402

ARCHS = ("qwen2-7b", "deepseek-v2-236b", "zamba2-2.7b", "xlstm-125m",
         "seamless-m4t-medium", "h2o-danube-3-4b")
MESHES = ((1, 2), (2, 1), (2, 2))
# a model axis that divides neither deepseek's experts nor its heads
THREE, THREE_ARCH = (1, 3), "deepseek-v2-236b"
# B=1 on (2, 1): an even cache splits its slots over the two data ranks
SPLIT = ("h2o-danube-3-4b", "deepseek-v2-236b", "qwen2-7b",
         "seamless-m4t-medium")
PROMPT, NEW, CACHE = 8, 5, 32
ATOL, RTOL = 1e-5, 1e-4
SPAWN_S = 300.0


def _cells(b: int):
    return [(f"{a}/b{b}", a, NEW, CACHE) for a in
            (ARCHS if b == 2 else SPLIT)]


@pytest.fixture(scope="module")
def params():
    return {a: jax.tree_util.tree_map(np.asarray, jget_model(
        jconfigs.get_config(a).reduced()).init(jax.random.PRNGKey(7)))
        for a in ARCHS}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    out = {}
    for b in (1, 2):
        for name, arch, _, _ in _cells(b):
            cfg = jconfigs.get_config(arch).reduced()
            prompts = rng.integers(0, cfg.vocab_size, (b, PROMPT)).astype(
                np.int32)
            frames = (rng.normal(size=(b, 6, cfg.d_model)).astype(np.float32)
                      if cfg.encoder_layers else None)
            out[name] = (prompts, frames)
    return out


@pytest.fixture(scope="module")
def ranks(params, batch):
    """mesh -> every rank's results: the three meshes' ranks run in the
    background while the reference decodes every cell."""
    from concurrent.futures import ThreadPoolExecutor
    cells = {(d, m): _cells(2) + (_cells(1) if (d, m) == (2, 1) else [])
             for d, m in MESHES}
    cells[THREE] = [c for c in _cells(2) if c[1] == THREE_ARCH]
    with ThreadPoolExecutor(len(cells)) as pool:
        futs = {(d, m): pool.submit(
            run_ranks, "_torch_dryrun_ranks:serve_cells", data=d, model=m,
            devices=["cpu"] * (d * m), backend="gloo", timeout_s=SPAWN_S,
            args=(c, params, batch)) for (d, m), c in cells.items()}
        for b in (1, 2):
            for name, arch, _, _ in _cells(b):
                _reference(arch, name, None, params[arch], batch)
        for i in range(2):                   # deepseek on (2, 2): per rank
            _reference("deepseek-v2-236b", "deepseek-v2-236b/b2",
                       slice(i, i + 1), params["deepseek-v2-236b"], batch)
        return {k: f.result() for k, f in futs.items()}


_REF: dict = {}


def _reference(arch, name, rows, params, batch):
    """The reference's greedy decode of ``batch[name]``'s ``rows`` (None:
    all): (tokens [B, NEW], logits per step, final state as {path:
    array}, the next tokens of prefill_step and of one serve_step after
    it); each computed once."""
    key = (name, None if rows is None else (rows.start, rows.stop))
    if key not in _REF:
        prompts, frames = batch[name]
        if rows is not None:
            prompts = prompts[rows]
            frames = None if frames is None else frames[rows]
        _REF[key] = _decode(arch, params, prompts, frames)
    return _REF[key]


def _decode(arch, params, prompts, frames):
    cfg = jconfigs.get_config(arch).reduced()
    model = jget_model(cfg)
    b = prompts.shape[0]
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def init():
        if cfg.encoder_layers:
            st = model.decode_init(b, CACHE, frames.shape[1])
            st["cross"] = jencdec.prefill_encoder(jp, cfg,
                                                  jnp.asarray(frames))
            return st
        if cfg.xlstm is not None:
            return model.decode_init(b)
        return model.decode_init(b, CACHE)

    step = jax.jit(model.decode_step)
    state, nxt = init(), jnp.asarray(prompts)
    toks, logits = [], []
    for _ in range(NEW):
        lg, state = step(jp, nxt, state)
        logits.append(np.asarray(lg, np.float32))
        nxt = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(nxt))
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        if path != "pos":
            flat[path] = np.asarray(leaf, np.float32)
    pre, st = jax.jit(jprefill(model))(jp, jnp.asarray(prompts), init())
    nxt2 = jax.jit(jserve(model))(jp, pre, st)[0]
    return (np.concatenate(toks, 1), logits, flat,
            np.concatenate([np.asarray(pre), np.asarray(nxt2)], 1))


def _rank_view(d, m, r):
    """A duck-typed mesh at rank ``r`` of (d, m): what ``ShardPlan.local``
    reads."""
    coord = {"data": r // m, "model": r % m}
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d, "model": m},
                                 index=lambda a: coord[a])


def _state_plans(arch, mesh, b, enc):
    model = get_model(jconfigs.get_config(arch).reduced())
    if model.cfg.encoder_layers:
        st = model.decode_init(b, CACHE, enc, device="meta")
    elif model.cfg.xlstm is not None:
        st = model.decode_init(b, device="meta")
    else:
        st = model.decode_init(b, CACHE, device="meta")
    plans = {}
    map_with_path(lambda p, pl: plans.__setitem__(p, pl),
                  state_shardings(mesh, st))
    return plans


def _check(name, arch, mesh_shape, got_all, params, batch, per_shard):
    d, m = mesh_shape
    prompts, frames = batch[name]
    b = prompts.shape[0]
    groups = [None]
    if per_shard:              # the reference routes each data rank's rows
        groups = [slice(i * b // d, (i + 1) * b // d) for i in range(d)]
    refs = [_reference(arch, name, g, params[arch], batch) for g in groups]
    if frames is not None and groups != [None]:
        raise AssertionError("enc-dec cells route no experts")
    for r, got in enumerate(got_all):
        toks, logits, state, layout, pre = got[name]
        view = _rank_view(d, m, r)
        t_plan = ShardPlan(view, spec_for(view, ("batch", None), (b, 1)),
                           (b, 1))
        rows = t_plan.local(torch.arange(b)[:, None]).reshape(-1).numpy()
        ref = refs[0] if not per_shard else refs[r // m]
        ref_rows = rows if not per_shard else rows - (r // m) * (b // d)
        np.testing.assert_array_equal(toks, ref[0][ref_rows])
        np.testing.assert_array_equal(pre, ref[3][ref_rows])
        for lg, want in zip(logits, ref[1]):
            np.testing.assert_allclose(lg, want[ref_rows], rtol=RTOL,
                                       atol=ATOL)
        if per_shard:
            continue
        plans = _state_plans(arch, view, b, 0 if frames is None
                             else frames.shape[1])
        assert set(state) == set(ref[2]), (set(state) ^ set(ref[2]))
        for path, arr in state.items():
            want = plans[path].local(torch.tensor(ref[2][path])).numpy()
            np.testing.assert_allclose(arr, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} rank {r} {path}")
    return got_all[0][name][3]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_decode_matches_the_reference(arch, mesh, ranks, params, batch):
    per_shard = (arch == "deepseek-v2-236b" and mesh == (2, 2))
    layout = _check(f"{arch}/b2", arch, mesh, ranks[mesh], params, batch,
                    per_shard)
    assert not layout["replicated_batch"] or mesh[0] == 1


@pytest.mark.parametrize("arch", SPLIT)
def test_b1_caches_split_over_the_data_axis(arch, ranks, params, batch):
    layout = _check(f"{arch}/b1", arch, (2, 1), ranks[(2, 1)], params,
                    batch, False)
    assert layout["replicated_batch"] and layout["self_split"]
    if arch == "seamless-m4t-medium":
        assert layout["cross_split"]


def test_mesh_decode_on_three_model_ranks(ranks, params, batch):
    """deepseek on (1, 3): the MoE layer's single-device branch with its
    experts whole and MLA over all heads on every rank, against the
    reference's single-device decode under the bounds above."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import spec_for
    layout = _check(f"{THREE_ARCH}/b2", THREE_ARCH, THREE, ranks[THREE],
                    params, batch, False)
    assert not any(layout.values())
    cfg = get_config(THREE_ARCH).reduced()
    view = _rank_view(*THREE, 0)
    assert cfg.num_heads % 3 and cfg.moe.num_experts % 3
    assert spec_for(view, ("expert", None, "model"), (
        cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert)) == (None,) * 3
