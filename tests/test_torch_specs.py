"""The port's shard plans (``launch/sharding.py``, ``launch/specs.py``)
against the reference's specs: the rule table (``infer_logical_axes``),
``spec_for`` and ``param_sharding(fsdp=True)`` for every parameter leaf
of every arch at its published width, and the batch, token and decode-
state specs of the 40 (arch x shape) cells of ``tests/test_specs.py``
(those the shape applies to), on meshes of (2, 2), (1, 4) and (16, 16).

The reference's rules read only a mesh's ``axis_names`` and ``shape``: its
side gets a ``jax.sharding.AbstractMesh`` (no devices), the port's a
duck-typed mesh.  Specs are compared as tuples (a one-axis tuple is its
axis name, as ``PartitionSpec`` normalises it).  Parameter and state
shapes come from ``jax.eval_shape`` (no arrays); the port's decode state
is built on the ``meta`` device, and its shapes are held to the
reference's too.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.steps import add_accum_dim as jadd_accum  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.steps import add_accum_dim  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402

MESHES = ((2, 2), (1, 4), (16, 16))
ARCHS = jconfigs.list_archs()
CELLS = [(a, s) for a in ARCHS for s in jconfigs.SHAPES
         if jconfigs.shape_applicable(jconfigs.get_config(a),
                                      jconfigs.SHAPES[s])[0]]


def _meshes(d, m):
    return (AbstractMesh((d, m), ("data", "model")),
            types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": d, "model": m}))


def _norm(spec) -> tuple:
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in spec)


def _paths(tree) -> dict:
    """path -> leaf, paths joined by '/' as jax.tree_util names them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): leaf for kp, leaf in flat}


def _port_paths(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def param_shapes():
    """arch -> {path: shape} of its published-width parameters."""
    return {a: {p: tuple(s.shape) for p, s in _paths(jax.eval_shape(
        lambda a=a: jget_model(jconfigs.get_config(a)).init(
            jax.random.PRNGKey(0)))).items()} for a in ARCHS}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_plans_equal_reference_specs(param_shapes, arch, mesh):
    jmesh, pmesh = _meshes(*mesh)
    cfg = configs.get_config(arch)
    structs = {p: torch.empty(s, device="meta")
               for p, s in param_shapes[arch].items()}
    plans = specs.param_shardings(pmesh, structs, cfg)
    for path, shape in param_shapes[arch].items():
        axes = jsh.infer_logical_axes(path, shape)
        assert sh.infer_logical_axes(path, shape) == axes, path
        assert sh.spec_for(pmesh, axes, shape) == _norm(
            jsh.spec_for(jmesh, axes, shape)), path
        for fsdp in (False, True):
            want = _norm(jsh.param_sharding(jmesh, axes, shape,
                                            fsdp=fsdp).spec)
            assert sh.param_sharding(pmesh, axes, shape,
                                     fsdp=fsdp).spec == want, (path, fsdp)
        want = _norm(jsh.param_sharding(jmesh, axes, shape,
                                        fsdp=cfg.fsdp).spec)
        plan = plans[path]
        assert plan.spec == want and plan.shape == shape, path
        ways = [int(np.prod([mesh[("data", "model").index(a)] for a in d]))
                for d in plan.dims]
        assert plan.local_shape == tuple(s // w for s, w in zip(shape, ways))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_batch_and_state_plans_equal_reference_specs(arch, shape_name, mesh):
    jmesh, pmesh = _meshes(*mesh)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    shape = jconfigs.SHAPES[shape_name]
    if shape.kind == "train":
        want = jspecs.batch_shardings(
            jmesh, jadd_accum(jcfg, jspecs.train_batch_structs(jcfg, shape)),
            accum_dim=True)
        structs = add_accum_dim(cfg, specs.train_batch_structs(cfg, shape))
        got = specs.batch_shardings(pmesh, structs, accum_dim=True)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].spec == _norm(want[k].spec), k
        return
    want_structs = _paths(jspecs.decode_state_structs(jget_model(jcfg),
                                                      shape))
    want = _paths(jspecs.state_shardings(
        jmesh, jspecs.decode_state_structs(jget_model(jcfg), shape)))
    structs = specs.decode_state_structs(get_model(cfg), shape)
    got = _port_paths(specs.state_shardings(pmesh, structs))
    assert sorted(got) == sorted(want)
    shapes = _port_paths(structs)
    for path, sharding in want.items():
        assert got[path].spec == _norm(sharding.spec), path
        leaf = shapes[path]
        assert (tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()) \
            == tuple(want_structs[path].shape), path
    # the step's tokens: batch-sharded, like every batch leaf
    b = shape.global_batch
    assert sh.spec_for(pmesh, ("batch", None), (b, 1)) == _norm(
        jsh.spec_for(jmesh, ("batch", None), (b, 1)))


def test_fallbacks_and_the_one_use_rule():
    """Prefix fallback, replication when nothing divides, each axis used
    once, and the pure-DP scope (batch over every axis, no TP)."""
    _, m = _meshes(16, 16)
    assert sh.spec_for(m, ("model", None), (28, 64)) == (None, None)
    assert sh.spec_for(m, ("batch", None), (32, 64)) == ("data", None)
    assert sh.spec_for(m, ("expert", None, "model"), (32, 8, 64)) == (
        "model", None, None)
    assert sh.spec_for(m, ("expert", None, "model"), (6, 8, 64)) == (
        None, None, "model")
    jm, _ = _meshes(16, 16)
    jcfg, cfg = (dataclasses.replace(c.get_config("gemma-2b"), pure_dp=True)
                 for c in (jconfigs, configs))
    with sh.arch_scope(cfg), jsh.arch_scope(jcfg):
        assert sh.batch_axes(m) == jsh.batch_axes(jm) == ("data", "model")
        assert sh.param_sharding(m, ("model", None), (256, 512),
                                 fsdp=True).spec == (
            None, ("data", "model")) == _norm(jsh.param_sharding(
                jm, ("model", None), (256, 512), fsdp=True).spec)
