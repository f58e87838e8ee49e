"""Gradient compression with error feedback (``repro_torch.optim.
compression``) against the reference's ``repro.optim.compression``.

``compress_int8`` / ``decompress_int8`` bit for bit (both round half to
even; the inputs include exact halves).  ``ef_compress_update`` over the
data group of 2 gloo ranks against the reference's ``psum`` form, run
under ``jax.vmap`` with a named axis of 2 (its ``psum`` over that axis is
the one ``shard_map`` would do), for 3 steps with the residual carried:
the int8 sums are exact integers and each rank scales by its own
``scale``, so the results agree bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jc  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.optim import compression as pc  # noqa: E402
import repro_torch.optim as popt  # noqa: E402

SPAWN_S = 120


def _x(seed, shape=(37, 5)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[:4] = [127.0, -63.5, 0.5, -1.5]       # exact halves of a step
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_round_trip_bit_for_bit(seed):
    x = _x(seed)
    jq, js = jc.compress_int8(jnp.asarray(x))
    q, s = pc.compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(pc.decompress_int8(q, s).numpy(),
                                  np.asarray(jc.decompress_int8(jq, js)))


def test_ef_without_a_group_matches_reference():
    tree = {"a": _x(3), "b": {"c": _x(4, (9,))}}
    ef, jef = (pc.ErrorFeedbackState.init(
        {"a": torch.zeros(37, 5), "b": {"c": torch.zeros(9)}}),
        jc.ErrorFeedbackState.init(tree))
    for step in range(2):
        g, ef = pc.ef_compress_update(
            jax.tree_util.tree_map(torch.from_numpy, tree), ef)
        jg, jef = jc.ef_compress_update(
            jax.tree_util.tree_map(jnp.asarray, tree), jef)
        for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda t: t.numpy(), (g, ef.residual))),
                jax.tree_util.tree_leaves((jg, jef.residual))):
            np.testing.assert_array_equal(a, np.asarray(b))
        tree = jax.tree_util.tree_map(lambda t: t * 0.5, tree)


def test_ef_over_two_ranks_matches_reference_psum():
    steps = [[{"w": _x(10 * s + r), "b": _x(10 * s + r + 5, (7,))}
              for r in range(2)] for s in range(3)]
    got = run_ranks("_torch_lm_mesh_ranks:ef_ranks", data=2, model=1,
                    devices=["cpu"] * 2, backend="gloo", args=(steps,),
                    timeout_s=SPAWN_S)

    def one(g, r):
        out, ef = jc.ef_compress_update(g, jc.ErrorFeedbackState(r),
                                        axis_name="data")
        return out, ef.residual
    stacked = [jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *step)
               for step in steps]
    res = jax.tree_util.tree_map(jnp.zeros_like, stacked[0])
    for s, g in enumerate(stacked):
        want, res = jax.vmap(one, axis_name="data")(g, res)
        for r in range(2):
            for name in ("w", "b"):
                np.testing.assert_array_equal(got[r][s][0][name],
                                              np.asarray(want[name][r]))
                np.testing.assert_array_equal(got[r][s][1][name],
                                              np.asarray(res[name][r]))


def test_optim_exports_compression():
    for name in ("compress_int8", "decompress_int8", "ErrorFeedbackState",
                 "ef_compress_update"):
        assert getattr(popt, name) is getattr(pc, name)
