"""The LM zoo trained on a mesh of ranks, against the reference's
``train_loop(mesh=)``: tensor and data parallelism for the dense and VLM
decoder-only family, data parallelism for the enc-dec and recurrent
families (their tensor parallelism, on (1, 2), (2, 2) and (1, 4), is
``tests/test_torch_lm_mesh_tp.py``'s, a file of its own so that the two
run on different workers), checkpoints across meshes.

The port runs one process per mesh position over ``torch.distributed``
(``gloo`` ranks on the CPU, spawned by ``launch.mesh.run_ranks``: one
spawn per mesh shape, every arch trained in it).  The reference runs its
own ``train_loop`` on a ``(data, model)`` mesh of 4 forced host devices,
once, in a subprocess (``tests/_lm_mesh_reference.py``), while the ranks
run.  Both start from the reference's parameters (drawn here with
``PRNGKey(0)``, as its ``train_loop`` draws them) and train 2 steps at
batch 4 x 32 in f32, lr 1e-3.

Tolerances (f32; GSPMD and the port split and order the sums of a
sharded product differently): losses rtol 1e-5 against the reference on
the same mesh, and against the port's own run without a mesh; final
parameters against the port's run without a mesh within 1e-5 but for at
most one element in 10,000 of the tree, and every element within 2·lr
per step: AdamW moves an element by about lr·sign(g) wherever its gradient g
is near zero, so a rounding-sized change of such a gradient can move it
by up to 2·lr (the bound).  The key bias ``bk`` (qwen2, internvl2) is
held to the bound alone: its true gradient is zero (softmax does not see
a shift of all of a query's logits), so its every element moves by
lr·sign(rounding noise).  The
replicated leaves (norms, biases left whole) are equal on every rank of a
model group bit for bit, and every rank reports the same losses.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

import _torch_lm_mesh_ranks as R  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SPAWN_S = 300
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
PARAM_OFF_SHARE = 1e-4       # the share of the tree's elements beyond it
MESHES = ((1, 2), (2, 1), (2, 2))
DENSE = (("gemma", "gemma-2b", {}),
         ("gemma-chunked", "gemma-2b", {"chunked_ce": 16}),
         ("qwen2", "qwen2-7b", {}),
         ("internvl2", "internvl2-1b", {}))
# trained here on (2, 1) alone; tensor parallel in test_torch_lm_mesh_tp
ENC_DEC_RECURRENT = (("seamless", "seamless-m4t-medium", {}),
                     ("xlstm", "xlstm-125m", {}),
                     ("zamba2", "zamba2-2.7b", {}))


def _cells(mesh):
    return DENSE + (ENC_DEC_RECURRENT if mesh == (2, 1) else ())


ALL = [(name, mesh) for mesh in MESHES for name, _, _ in _cells(mesh)]


def _np_params(archs):
    return {a: jax.tree_util.tree_map(
        np.asarray, jget_model(jconfigs.get_config(a).reduced()).init(
            jax.random.PRNGKey(0))) for a in archs}


class Reference:
    """The reference's runs in a background subprocess (module
    docstring); :meth:`losses` waits for it.  ``devices``: the forced
    host devices it runs on (a mesh takes the first data·model)."""

    def __init__(self, tmp: Path, cells: list, devices: int = 4) -> None:
        self.out = tmp / "ref_out.json"
        spec = tmp / "ref_cells.json"
        spec.write_text(json.dumps(cells))
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   LM_MESH_REF_DEVICES=str(devices))
        self.proc = subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_lm_mesh_reference.py"),
             str(spec), str(self.out)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._losses = None

    def losses(self) -> dict:
        if self._losses is None:
            _, err = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, err[-4000:]
            self._losses = json.loads(self.out.read_text())
        return self._losses


def ref_cell(name, arch, kw, mesh):
    return {"name": name, "arch": arch, "kw": kw,
            "mesh": None if mesh is None else list(mesh), "steps": R.STEPS,
            "batch": R.BATCH, "seq_len": R.SEQ, "lr": R.LR}


@pytest.fixture(scope="module")
def params():
    return _np_params({a for _, a, _ in DENSE + ENC_DEC_RECURRENT})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cells = [ref_cell(f"{n}@{m}", a, kw, m) for m in MESHES
             for n, a, kw in _cells(m)]
    return Reference(tmp_path_factory.mktemp("lm_mesh_ref"), cells)


@pytest.fixture(scope="module")
def ranks(params, reference, tmp_path_factory):
    """mesh -> every rank's results (the ranks run while the reference
    does); the (1, 2) world also saves and resumes a checkpoint."""
    ck = tmp_path_factory.mktemp("lm_mesh_ck") / "ck"
    out = {}
    for d, m in MESHES:
        out[(d, m)] = run_ranks(
            "_torch_lm_mesh_ranks:train_ranks", data=d, model=m,
            devices=["cpu"] * (d * m), backend="gloo", timeout_s=SPAWN_S,
            args=(list(_cells((d, m))), params,
                  str(ck) if (d, m) == (1, 2) else None))
    out["ckpt_dir"] = ck
    return out


@pytest.fixture(scope="module")
def single(params):
    """The port's run without a mesh, per cell: (losses, params)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {n: R.train(R.cfg_of(a, kw), params[a], None, "cpu")
                for n, a, kw in DENSE + ENC_DEC_RECURRENT}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name,mesh", ALL)
def test_losses_match_reference_on_the_same_mesh(ranks, reference, name,
                                                  mesh):
    want = reference.losses()[f"{name}@{mesh}"]
    got = [r[name][0] for r in ranks[mesh]]
    for g in got:                        # every rank reports the same loss
        assert g == got[0]
    np.testing.assert_allclose(got[0], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name,mesh", ALL)
def test_mesh_run_matches_the_run_without_a_mesh(ranks, single, name, mesh):
    """Losses rtol 1e-5; every leaf, its blocks put together, as the run
    without a mesh (module docstring); the replicated leaves equal on
    every rank bit for bit."""
    got = ranks[mesh]
    losses, want = single[name]
    np.testing.assert_allclose(got[0][name][0], losses, rtol=LOSS_RTOL)
    d, m = mesh
    flat_want = _flat(want)
    blocks = [_flat(r[name][1]) for r in got]
    off = size = 0
    for path, full in flat_want.items():
        local = [b[path] for b in blocks]
        whole = _assemble(local, full.shape, d, m)
        np.testing.assert_allclose(whole, full, rtol=0,
                                   atol=2 * R.LR * R.STEPS, err_msg=path)
        if not path.endswith("/bk"):
            off += int(np.sum(np.abs(whole - full) > PARAM_ATOL))
            size += full.size
        if local[0].shape == full.shape:          # replicated
            for x in local[1:]:
                assert np.array_equal(x, local[0]), path
    assert off <= size * PARAM_OFF_SHARE, (off, size)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _assemble(local: list, shape: tuple, d: int, m: int) -> np.ndarray:
    """Rank r = di·m + mi holds a block; a dim whose block is 1/m of it
    is split over model, 1/d over data (ZeRO-3), else whole."""
    out = np.asarray(local[0])
    if out.shape == tuple(shape):
        return out
    grid = [[np.asarray(local[di * m + mi]) for mi in range(m)]
            for di in range(d)]
    for dim, (n, full) in enumerate(zip(out.shape, shape)):
        if n != full and full // n == m and m > 1:
            grid = [[np.concatenate(row, axis=dim)] for row in grid]
    for dim, (n, full) in enumerate(zip(grid[0][0].shape, shape)):
        if n != full:
            grid = [[np.concatenate([row[0] for row in grid], axis=dim)]]
    whole = grid[0][0]
    assert whole.shape == tuple(shape), (whole.shape, shape)
    return whole


def test_checkpoint_resumes_on_the_same_mesh_and_on_one_device(ranks,
                                                                params):
    """Saved on (1, 2) after 2 steps: resumed there, step 3's loss equals
    the uninterrupted run's bit for bit; resumed on one device, within
    1e-5; the files hold whole leaves."""
    r0 = ranks[(1, 2)][0]
    assert r0["resumed"] == r0["full3"][2:]
    cfg = R.cfg_of("gemma-2b", {})
    one = R.train(cfg, params["gemma-2b"], None, "cpu", steps=3,
                  ckpt_dir=str(ranks["ckpt_dir"]), ckpt_every=100,
                  resume=True)[0]
    np.testing.assert_allclose(one, r0["full3"][2:], rtol=LOSS_RTOL)
    manifest = json.loads((Path(ranks["ckpt_dir"]) / "step_00000002" /
                           "manifest.json").read_text())
    for path, shape in _flat(jax.tree_util.tree_map(
            np.shape, params["gemma-2b"])).items():
        for tree in ("0", "1/m", "1/v"):      # params, moments
            assert tuple(manifest["leaves"][f"{tree}/{path}"]["shape"]) \
                == shape, path


def test_remat_recompute_reenters_the_mesh_scope():
    """Backward may run on another thread than the forward (CUDA's
    autograd has a thread per device): the recompute of a remat'd block
    must see the forward's mesh, which the layers' branches read."""
    import threading
    from repro_torch.launch.sharding import current_mesh, use_mesh
    from repro_torch.models.scan_util import remat_call

    def f(x):
        k = 2.0 if current_mesh() is not None else 3.0
        return (x * k) ** 2

    x = torch.arange(1.0, 4.0, requires_grad=True)
    with use_mesh(object()):
        y = remat_call(f, x).sum()
    box = {}
    t = threading.Thread(target=lambda: box.update(
        g=torch.autograd.grad(y, x)[0]))
    t.start()
    t.join()
    assert torch.equal(box["g"], 8.0 * x.detach())
