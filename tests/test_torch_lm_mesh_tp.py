"""Tensor parallelism for the enc-dec and recurrent LM families on a mesh
of ranks: seamless-m4t-medium, xlstm-125m and zamba2-2.7b (reduced, f32)
trained by ``train_loop(mesh=)`` on (1, 2), (2, 2) and (1, 4) gloo CPU
ranks, against the reference's ``train_loop(mesh=)`` on the same mesh;
a checkpoint saved on (1, 2) resumed on (1, 4) and on one device; and
one layer at a time (cross-attention, the Mamba2 block, the mLSTM and
sLSTM cells, deepseek's MLA head-local) on 2 and 4 ranks against the same
layer on one device, and the collectives the head-local MLA issues.

The runs, parameters and tolerances are those of
``tests/test_torch_lm_mesh.py`` (its module docstring): both packages
start from the reference's parameters, 2 steps at batch 4 x 32, lr 1e-3;
losses rtol 1e-5 against the reference on the same mesh and against the
port's run without a mesh; final parameters against that run within 1e-5
for all but one element in 10,000 of the tree and every element within
2·lr a step; leaves left whole equal bit for bit on every rank of a model
group.  One spawn per mesh shape, in order: (1, 2) saves the
checkpoints, (1, 4) resumes them.

xlstm's two steps are chaotic at f32's rounding: one ulp added to or
taken from every starting parameter (the port's run without a mesh)
moves 2 to 4% of the tree's elements beyond 1e-5 (6,320 to 12,176 of
285,184, three draws), through the mLSTM's normaliser and AdamW's second
step, while its loss stays within 2e-6.  Tensor parallelism reorders
sums (a row-parallel product, a norm's squares, a gradient summed over
the group) and moves 36 to 276 of them.  So its share beyond 1e-5 is
held to a tenth of what such a perturbation moves, measured here
(:data:`NOISY`); seamless and zamba2 keep the one in 10,000.

Layers (f32, noise added to every leaf so that the norm scales' gradients
are not those of zeros): the output, the gradient of ``sum(out · w)``
with respect to the input (and the encoder output), and each leaf's
gradient, this rank's block of it, within 1e-5 of the largest magnitude of
the one-device tensor; the gradients of leaves left whole equal on every
rank bit for bit.  The cases cover the splits that do not follow the
heads (Mamba2's ``in_proj`` columns, 296 on 2 or 4 ranks, and its
``conv_w`` channels across ``x | B | C``) and heads that do not divide the
axis (2 heads on 4 ranks: the layer whole on every rank).
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.launch.mesh import run_ranks  # noqa: E402

import _torch_lm_mesh_ranks as R  # noqa: E402
from test_torch_lm_mesh import (LOSS_RTOL, PARAM_ATOL,  # noqa: E402
                                PARAM_OFF_SHARE, SPAWN_S, Reference,
                                _assemble, _flat, _np_params, ref_cell)

MESHES = ((1, 2), (2, 2), (1, 4))     # in spawn order: (1, 2) saves
SAVE_MESH, RESUME_MESH = (1, 2), (1, 4)
ARCHS = (("seamless", "seamless-m4t-medium", {}),
         ("xlstm", "xlstm-125m", {}),
         ("zamba2", "zamba2-2.7b", {}))
CELLS = [(name, mesh) for mesh in MESHES for name, _, _ in ARCHS]
# (kind, heads, seed) on 2 and 4 ranks; the tp column: which of them
LAYERS = (("cross", 4, 1, (2, 4)), ("cross", 2, 8, (4,)),
          ("mamba2", 8, 2, (2, 4)),
          ("mamba2", 2, 3, (4,)), ("mlstm", 4, 4, (2, 4)),
          ("mlstm", 2, 5, (4,)), ("slstm", 4, 6, (2, 4)),
          ("slstm", 2, 7, (4,)), ("mla", 4, 9, (2, 4)))
LAYER_CASES = [(f"{k}/{h}", tp) for k, h, _, tps in LAYERS for tp in tps]
LAYER_TOL = 1e-5
NOISY = ("xlstm",)      # share beyond PARAM_ATOL: module docstring
NOISE_MARGIN = 10


@pytest.fixture(scope="module")
def params():
    return _np_params({a for _, a, _ in ARCHS})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cells = [ref_cell(f"{n}@{m}", a, kw, m) for m in MESHES
             for n, a, kw in ARCHS]
    return Reference(tmp_path_factory.mktemp("lm_mesh_tp_ref"), cells)


@pytest.fixture(scope="module")
def ranks(params, reference, tmp_path_factory):
    """mesh -> every rank's results (the ranks run while the reference
    does)."""
    ck = tmp_path_factory.mktemp("lm_mesh_tp_ck")
    out = {}
    for d, m in MESHES:
        layers = [(k, h, seed) for k, h, seed, tps in LAYERS
                  if d == 1 and m in tps]
        ckpt = str(ck) if (d, m) in (SAVE_MESH, RESUME_MESH) else None
        out[(d, m)] = run_ranks(
            "_torch_lm_mesh_ranks:tp_ranks", data=d, model=m,
            devices=["cpu"] * (d * m), backend="gloo", timeout_s=SPAWN_S,
            args=(list(ARCHS), params, ckpt, (d, m) == RESUME_MESH,
                  layers))
    out["ckpt_dir"] = ck
    return out


def _one_ulp(tree: dict, seed: int) -> dict:
    """Every element of a numpy tree moved by one ulp, up or down."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        inf = np.float32(np.inf)
        return np.nextafter(a, np.where(rng.random(a.shape) < 0.5, inf,
                                        -inf).astype(np.float32))
    return jax.tree_util.tree_map(one, tree)


def _off(got: dict, want: dict) -> int:
    return sum(int(np.sum(np.abs(got[k] - want[k]) > PARAM_ATOL))
               for k in want)


@pytest.fixture(scope="module")
def single(params):
    """The port's run without a mesh, per arch: (losses, params, the
    elements beyond PARAM_ATOL that one ulp moves; module docstring)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for n, a, kw in ARCHS:
            cfg = R.cfg_of(a, kw)
            losses, final = R.train(cfg, params[a], None, "cpu")
            floor = None
            if n in NOISY:
                moved = R.train(cfg, _one_ulp(params[a], 0), None,
                                "cpu")[1]
                floor = _off(_flat(moved), _flat(final))
            out[n] = (losses, final, floor)
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name,mesh", CELLS)
def test_losses_match_reference_on_the_same_mesh(ranks, reference, name,
                                                  mesh):
    want = reference.losses()[f"{name}@{mesh}"]
    got = [r["train"][name][0] for r in ranks[mesh]]
    for g in got:                        # every rank reports the same loss
        assert g == got[0]
    np.testing.assert_allclose(got[0], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name,mesh", CELLS)
def test_mesh_run_matches_the_run_without_a_mesh(ranks, single, name, mesh):
    """Losses rtol 1e-5; every leaf, its blocks put together, as the run
    without a mesh; the leaves left whole equal on every rank bit for
    bit (module docstring)."""
    got = [r["train"][name] for r in ranks[mesh]]
    losses, want, floor = single[name]
    np.testing.assert_allclose(got[0][0], losses, rtol=LOSS_RTOL)
    d, m = mesh
    blocks = [_flat(r[1]) for r in got]
    off = size = split = 0
    for path, full in _flat(want).items():
        local = [b[path] for b in blocks]
        whole = _assemble(local, full.shape, d, m)
        np.testing.assert_allclose(whole, full, rtol=0,
                                   atol=2 * R.LR * R.STEPS, err_msg=path)
        off += int(np.sum(np.abs(whole - full) > PARAM_ATOL))
        size += full.size
        if local[0].shape == full.shape:          # whole on every rank
            for x in local[1:]:
                assert np.array_equal(x, local[0]), path
        else:
            split += 1
    if floor is None:
        assert off <= size * PARAM_OFF_SHARE, (off, size)
    else:
        assert off * NOISE_MARGIN <= floor, (off, floor, size)
    assert split, "no leaf was split over the mesh"


@pytest.mark.parametrize("name", [n for n, _, _ in ARCHS])
def test_checkpoint_from_1x2_resumes_on_1x4_and_on_one_device(
        ranks, params, name):
    """Saved on (1, 2) after 2 steps (whole leaves in the files): resumed
    on (1, 4) and on one device, step 3's loss within 1e-5 of the
    uninterrupted (1, 2) run's."""
    arch = dict((n, a) for n, a, _ in ARCHS)[name]
    full3 = ranks[SAVE_MESH][0]["full3"][name]
    for r in ranks[RESUME_MESH]:
        np.testing.assert_allclose(r["resumed"][name], full3[2:],
                                   rtol=LOSS_RTOL)
    ck = Path(ranks["ckpt_dir"]) / name
    one = R.train(R.cfg_of(arch, {}), params[arch], None, "cpu", steps=3,
                  ckpt_dir=str(ck), ckpt_every=100, resume=True)[0]
    np.testing.assert_allclose(one, full3[2:], rtol=LOSS_RTOL)
    manifest = json.loads((ck / "step_00000002" / "manifest.json")
                          .read_text())
    for path, shape in _flat(jax.tree_util.tree_map(
            np.shape, params[arch])).items():
        assert tuple(manifest["leaves"][f"0/{path}"]["shape"]) == shape, \
            path


@pytest.mark.parametrize("case,tp", LAYER_CASES)
def test_layer_on_ranks_matches_one_device(ranks, case, tp):
    results = [r["layers"][case] for r in ranks[(1, tp)]]
    for res in results:
        (one_out, one_g), (out, g) = res["one"], res["mesh"]
        np.testing.assert_allclose(out, one_out, rtol=0,
                                   atol=LAYER_TOL * np.abs(one_out).max())
        assert sorted(g) == sorted(one_g)
        for k, want in one_g.items():
            np.testing.assert_allclose(
                g[k], want, rtol=0, atol=LAYER_TOL * np.abs(want).max(),
                err_msg=k)
    split = set(results[0]["split"])
    assert split, "no leaf was split over the mesh"
    for k, g0 in results[0]["mesh"][1].items():
        if k not in split:                      # whole leaves and inputs
            for res in results[1:]:
                assert np.array_equal(res["mesh"][1][k], g0), k


@pytest.mark.parametrize("tp", (2, 4))
def test_head_local_mla_sums_each_input_gradient_once(ranks, tp):
    """Head-local MLA issues four all-reduces a forward and backward: the
    sum of ``wo``'s row blocks, and one gradient sum each for the latents
    that the column blocks read (``q_up``'s input, and ``c_kv`` that both
    ``k_up`` and ``v_up`` read) and for the shared ``k_rope``."""
    for r in ranks[(1, tp)]:
        assert r["layers"]["mla/4"]["collectives"] == ["all-reduce"] * 4
