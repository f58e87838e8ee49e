"""Port parity for checkpoints: ``repro_torch.checkpoint`` against
``repro.checkpoint``, the engine's ``save`` / ``restore``, and the
training example's ``--ckpt-dir``.

The two packages share one format (``arrays.npz`` keyed by tree path plus
``manifest.json``), so a checkpoint either writes loads into the other:
the same paths, leaf shapes and dtypes, the AdamW ``step`` as an int32
scalar on both sides.  Values round-trip exactly (``torch.equal`` /
``assert_array_equal``).  The store's own behaviour (atomic publish,
keep-N, the ``aux`` payload, ``CheckpointManager``) is checked as
``tests/test_checkpoint.py`` checks the reference's.
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
jnp = jax.numpy

from _torch_parity import jax_params_to_numpy  # noqa: E402
from repro import checkpoint as ckpt_ref  # noqa: E402
from repro.checkpoint import store as store_ref  # noqa: E402
from repro.gns import EngineConfig as EngineConfigRef  # noqa: E402
from repro.gns import GNSEngine as EngineRef  # noqa: E402
from repro.graph.datasets import get_dataset  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import store as store_port  # noqa: E402
from repro_torch.gns import EngineConfig, GNSEngine  # noqa: E402
from repro_torch.models import graphsage as sage_port  # noqa: E402
from repro_torch.optim import adam as adam_port  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ds():
    return get_dataset("tiny", seed=0)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": [{"w": torch.randn((4, 8), generator=g),
                        "b": torch.zeros((8,))}],
            "step_scale": np.float32(1.5)}


def _cfg_json(name="gns") -> str:
    from repro.core.sampler import SamplerConfig
    from repro.featurestore import CacheConfig
    from repro.gns.config import DataConfig, ModelConfig
    scfg = SamplerConfig(fanouts=(2, 3, 4), batch_size=32,
                         cache=CacheConfig(fraction=0.05))
    cfg = EngineConfigRef(
        sampler=name, data=DataConfig(name="tiny", scale=1.0),
        sampling=scfg, cache=scfg.cache,
        model=ModelConfig(hidden_dim=32, input_impl="fused"), seed=0)
    return json.dumps(cfg.to_dict())


def _engines(ds, name="gns"):
    text = _cfg_json(name)
    ref = EngineRef(EngineConfigRef.from_dict(json.loads(text)), dataset=ds)
    port = GNSEngine(EngineConfig.from_dict(json.loads(text)), device="cpu",
                     dataset=ds)
    return ref, port


def _assert_state_equal(ref, port):
    """The reference engine's params and moments equal the port's."""
    want = jax_params_to_numpy(ref.params)
    for lw, lp in zip(want["layers"], port.params["layers"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(lp[k].numpy(), lw[k])
    for m in ("m", "v"):
        want = jax_params_to_numpy(ref.opt_state[m])
        for lw, lp in zip(want["layers"], port.opt_state[m]["layers"]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(lp[k].numpy(), lw[k])
    assert port.opt_state["step"] == int(ref.opt_state["step"])


def _manifest(path: Path) -> dict:
    return json.loads((path / "manifest.json").read_text())


# ---------------------------------------------------------------------------
# the store, as tests/test_checkpoint.py checks the reference's
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save_checkpoint(tmp_path, 7, t, extra={"epoch": 3})
    loaded, step, extra = ckpt.load_checkpoint(tmp_path, t)
    assert step == 7 and extra == {"epoch": 3}
    for a, b in zip(t["layers"][0].values(), loaded["layers"][0].values()):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    assert loaded["step_scale"] == np.float32(1.5)


def test_keep_n_and_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, t, keep=2)
    steps = sorted(p.name for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "missing") is None


def test_partial_write_is_invisible(tmp_path):
    """A crash mid-write (simulated leftover tmp dir) must not be loadable,
    and a write that fails leaves no tmp dir behind."""
    t = _tree()
    ckpt.save_checkpoint(tmp_path, 1, t)
    junk = tmp_path / ".step_9_partial"
    junk.mkdir()
    (junk / "arrays.npz").write_bytes(b"corrupt")
    assert ckpt.latest_step(tmp_path) == 1       # tmp dirs never candidates
    _, step, _ = ckpt.load_checkpoint(tmp_path, t)
    assert step == 1
    with pytest.raises(TypeError):
        ckpt.save_checkpoint(tmp_path, 2, t, extra={"bad": object()})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        ".step_9_partial", "step_00000001"]


def test_shape_mismatch_rejected(tmp_path):
    t = _tree()
    ckpt.save_checkpoint(tmp_path, 1, t)
    bad = {"layers": [{"w": torch.zeros((5, 8)), "b": torch.zeros((8,))}],
           "step_scale": np.float32(0.0)}
    with pytest.raises(AssertionError):
        ckpt.load_checkpoint(tmp_path, bad)


def test_manager_restore_or_init(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, every=2, keep=3)
    t = _tree()
    fresh = _tree(seed=1)
    assert mgr.restore_or_init(fresh) == (fresh, 0, {})
    assert mgr.maybe_save(1, t) is None        # not on cadence
    assert mgr.maybe_save(2, t) is not None
    t2, step, _ = mgr.restore_or_init(_tree(seed=1))
    assert step == 2
    assert torch.equal(t2["layers"][0]["w"], t["layers"][0]["w"])


def test_aux_payload_roundtrip(tmp_path):
    """``aux`` rides beside the tree, shapes free between saves; a
    checkpoint without one reads back {}; the manifest lists it."""
    t = _tree()
    aux = {"stream/ops": np.arange(7, dtype=np.int64),
           "stream/feats": torch.ones((3, 2))}
    path = ckpt.save_checkpoint(tmp_path, 1, t, aux=aux)
    got = ckpt.load_aux(tmp_path)
    np.testing.assert_array_equal(got["stream/ops"], aux["stream/ops"])
    np.testing.assert_array_equal(got["stream/feats"], np.ones((3, 2)))
    assert _manifest(path)["aux"]["stream/ops"] == {"shape": [7],
                                                    "dtype": "int64"}
    ckpt.save_checkpoint(tmp_path, 2, t)
    assert ckpt.load_aux(tmp_path) == {}
    # the reference reads the port's aux payload
    np.testing.assert_array_equal(ckpt_ref.load_aux(tmp_path, 1)["stream/ops"],
                                  aux["stream/ops"])


def test_bf16_leaf_is_refused_by_name(tmp_path):
    """A leaf numpy cannot hold is refused, naming the leaf, and nothing
    is published.  A bf16 leaf is no longer such a leaf: it is written as
    its raw bytes (the bf16 tests below), so the case is a float8 leaf."""
    t = {"layers": [{"w": torch.zeros((2, 2), dtype=torch.float8_e4m3fn)}]}
    with pytest.raises(TypeError, match="layers/0/w"):
        ckpt.save_checkpoint(tmp_path, 1, t)
    assert ckpt.latest_step(tmp_path) is None
    assert list(tmp_path.iterdir()) == []


def _bf16_ref_tree(seed=0):
    """An LM-like (params, opt_state) tree: bf16 stacked and tied leaves,
    f32 norms and moments, the int32 step, as the reference holds it."""
    rng = np.random.default_rng(seed)
    p = {"embed": jnp.asarray(rng.standard_normal((7, 4)), jnp.bfloat16),
         "final_norm": jnp.asarray(rng.standard_normal(4), jnp.float32),
         "layers": {"wq": jnp.asarray(rng.standard_normal((2, 4, 4)),
                                      jnp.bfloat16)}}
    m = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32) * 0.5, p)
    return (p, {"m": m, "v": m, "step": jnp.asarray(3, jnp.int32)})


def _as_port(tree):
    """The same tree as the port holds it: bf16 tensors, step an int."""
    def leaf(a):
        if a.ndim == 0:
            return int(a)
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(leaf, tree)


def _bits(x) -> np.ndarray:
    """A leaf's raw bits: a 2-byte leaf (a bf16 tensor, a bfloat16 or V2
    array) as int16."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def test_reference_bf16_checkpoint_loads_into_the_port_bit_for_bit(tmp_path):
    """A bf16 tree saved by the reference loads into the port's bf16
    tensors bit for bit (the reference's own loader hands those leaves
    back as raw V2 bytes)."""
    tree = _bf16_ref_tree()
    ckpt_ref.save_checkpoint(tmp_path, 3, tree)
    like = jax.tree_util.tree_map(lambda x: torch.zeros_like(x)
                                  if isinstance(x, torch.Tensor) else 0,
                                  _as_port(tree))
    got, step, _ = ckpt.load_checkpoint(tmp_path, like)
    assert step == 3 and got[1]["step"] == 3
    assert got[0]["embed"].dtype == torch.bfloat16
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    raw, _, _ = ckpt_ref.load_checkpoint(tmp_path, tree)
    assert raw[0]["embed"].dtype == np.dtype("V2")


def test_port_bf16_checkpoint_has_the_reference_layout(tmp_path):
    """The port writes a bf16 tensor as the reference writes a bf16 leaf:
    the same manifest (dtype "bfloat16") and the same 2-byte patterns in
    ``arrays.npz``; the port reads its own back bit for bit, on the
    device asked for."""
    tree = _bf16_ref_tree(1)
    a = ckpt_ref.save_checkpoint(tmp_path / "ref", 3, tree)
    b = ckpt.save_checkpoint(tmp_path / "port", 3, _as_port(tree))
    assert _manifest(a) == _manifest(b)
    assert _manifest(b)["leaves"]["0/embed"]["dtype"] == "bfloat16"
    with np.load(a / "arrays.npz") as za, np.load(b / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype.itemsize == zb[k].dtype.itemsize
            assert za[k].tobytes() == zb[k].tobytes(), k
    port = _as_port(tree)
    got, _, _ = ckpt.load_checkpoint(tmp_path / "port", port, device="meta")
    assert got[0]["layers"]["wq"].device.type == "meta"
    assert got[0]["layers"]["wq"].dtype == torch.bfloat16
    got, _, _ = ckpt.load_checkpoint(tmp_path / "port", port)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(port)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_load_places_leaves_on_the_given_device(tmp_path):
    t = _tree()
    ckpt.save_checkpoint(tmp_path, 1, t)
    loaded, _, _ = ckpt.load_checkpoint(tmp_path, t, device="meta")
    assert loaded["layers"][0]["w"].device.type == "meta"
    loaded, _, _ = ckpt.load_checkpoint(tmp_path, t)
    assert loaded["layers"][0]["w"].device.type == "cpu"


# ---------------------------------------------------------------------------
# one format: paths, manifests, cross-loading
# ---------------------------------------------------------------------------

def test_paths_match_jax_tree_util():
    """Dict keys by name in sorted order, list and tuple items by index,
    joined by '/', as ``jax.tree_util.tree_map_with_path`` gives them."""
    rng = np.random.default_rng(0)
    tree = ({"layers": [{"w": rng.normal(size=(3, 2)), "b": np.zeros(2)},
                        {"w": rng.normal(size=(2, 2)), "b": np.ones(2)}],
             "zeta": np.float32(1), "alpha": [np.int32(3), (np.zeros(1),)]},
            {"m": {"x": np.zeros(3)}, "step": np.int32(4), "none": None})
    want = store_ref._flatten(tree)
    got = store_port._flatten(tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_engine_state_manifest_matches_reference(tmp_path, ds):
    """The same engine state saved by each package: the manifests are
    equal leaf for leaf (paths, shapes, dtypes; the step an int32
    scalar), and so are the arrays."""
    ref, port = _engines(ds)
    ref.fit(1, max_batches=2)
    port.params = sage_port.params_from_numpy(jax_params_to_numpy(ref.params),
                                              device="cpu")
    port.opt_state = adam_port.adam_state_from_numpy(
        jax.device_get(ref.opt_state), device="cpu")
    a = ref.save(tmp_path / "ref", step=2)
    b = port.save(tmp_path / "port", step=2)
    ma, mb = _manifest(a), _manifest(b)
    assert ma == mb
    assert list(ma["leaves"]) == list(mb["leaves"])
    assert mb["leaves"]["opt_state/step"] == {"shape": [], "dtype": "int32"}
    assert mb["leaves"]["params/layers/0/w"]["dtype"] == "float32"
    with np.load(a / "arrays.npz") as za, np.load(b / "arrays.npz") as zb:
        assert za.files == zb.files
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])


def test_reference_checkpoint_restores_into_the_port(tmp_path, ds):
    ref, port = _engines(ds)
    ref.fit(1, max_batches=3)
    port.fit(1, max_batches=3)       # the same sampler and cache state
    ref.save(tmp_path, step=3)
    assert port.restore(tmp_path) == 3
    _assert_state_equal(ref, port)
    assert port.params["layers"][0]["w"].device == port.device
    # and the port trains on from it as the reference does
    rep_r = ref.fit(1, max_batches=1)
    rep_p = port.fit(1, max_batches=1)
    assert np.isfinite(rep_p.losses).all()
    assert port.opt_state["step"] == int(ref.opt_state["step"]) == 4
    np.testing.assert_allclose(rep_p.losses, rep_r.losses, rtol=1e-4,
                               atol=1e-5)


def test_port_checkpoint_restores_into_the_reference(tmp_path, ds):
    ref, port = _engines(ds, "ladies")
    port.fit(1, max_batches=3)
    port.save(tmp_path, step=5, keep=1)
    assert ref.restore(tmp_path) == 5
    _assert_state_equal(ref, port)
    assert ref.opt_state["step"].dtype == np.int32


def test_engine_save_restore_roundtrip(tmp_path, ds):
    """``save`` then ``restore`` into a fresh engine: parameters and
    moments exactly, the step, the newest step by default and an older
    one by request; keep-N applies."""
    _, a = _engines(ds, "lazygcn")
    a.fit(1, max_batches=2)
    a.save(tmp_path, step=2)
    a.fit(1, max_batches=2)
    a.save(tmp_path, step=4, keep=2)
    _, b = _engines(ds, "lazygcn")
    assert b.restore(tmp_path) == 4
    for la, lb in zip(a.params["layers"], b.params["layers"]):
        for k in ("w", "b"):
            assert torch.equal(la[k], lb[k])
    for m in ("m", "v"):
        for la, lb in zip(a.opt_state[m]["layers"],
                          b.opt_state[m]["layers"]):
            for k in ("w", "b"):
                assert torch.equal(la[k], lb[k])
    assert b.opt_state["step"] == a.opt_state["step"] == 4
    assert b.restore(tmp_path, step=2) == 2 and b.opt_state["step"] == 2
    assert _manifest(tmp_path / "step_00000004")["extra"] == {"seed": 0}


# ---------------------------------------------------------------------------
# the example twins
# ---------------------------------------------------------------------------

def _run_example(name: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, str(REPO / "examples" / name),
                           "--dataset", "tiny", "--device", "cpu", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_training_example_checkpoints_and_resumes(tmp_path):
    args = ("--scale", "1", "--batch-size", "100", "--steps", "10",
            "--sampler", "lazygcn", "--input-impl", "fused",
            "--ckpt-dir", str(tmp_path))
    out = _run_example("train_gns_graphsage_torch.py", *args)
    assert "== LAZYGCN on tiny (1 epochs x 10 steps) ==" in out
    assert ckpt.latest_step(tmp_path) == 1
    out = _run_example("train_gns_graphsage_torch.py", *args)
    assert "resumed from the checkpoint of epoch 1 (optimizer step 10)" \
        in out
    assert ckpt.latest_step(tmp_path) == 2
    man = _manifest(tmp_path / "step_00000002")
    assert man["leaves"]["1/step"] == {"shape": [], "dtype": "int32"}


def test_quickstart_example_runs():
    out = _run_example("quickstart_torch.py", "--epochs", "1",
                       "--max-batches", "2", "--batch-size", "32")
    assert "== NS on cpu ==" in out and "== GNS on cpu ==" in out
    assert "GNS vs NS:" in out
