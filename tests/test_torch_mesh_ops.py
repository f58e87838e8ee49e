"""Port parity of the sharded kernel call paths: K1 per cache shard with its
three ways of combining the partials, its mesh backward, and K3 over a
shard's row range.

The port runs one process per mesh position over ``torch.distributed``
(``gloo`` here: ranks spawned by ``repro_torch.launch.mesh.run_ranks`` on
the CPU).  The reference runs its own sharded op, ``shard_map`` over 4
forced host devices, once in a subprocess (as its
``tests/test_sharded_store.py`` does).  The same integer-valued inputs,
made here from seeds with numpy, go to both: the forwards must agree bit
for bit (the partials hold exact integers, so the order of the sums does
not matter), the gradients within 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.kernels import cache_lookup as k1_ref  # noqa: E402
from repro_torch.kernels import cache_lookup as k1_port  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.sampling import kernels as k3_port  # noqa: E402
from repro_torch.sampling.adjacency import DeviceCacheAdj  # noqa: E402
from repro_torch.sampling.ref import slot_gather_agg_plain  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SPAWN_S = 240          # deadline of one spawn of ranks
PATHS = ("psum", "static", "dynamic", "dynamic_off")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _slots(rng, s0, n_hits, lo, hi):
    """[s0] int32: ``n_hits`` positions hold distinct slots of [lo, hi)."""
    out = np.full(s0, -1, np.int32)
    pos = rng.choice(s0, n_hits, replace=False)
    out[pos] = rng.choice(np.arange(lo, hi), n_hits, replace=False)
    return out


def _lookup_case(seed, groups, shards, c=32, d=16, s0=24, b=12, k=5):
    """Integer-valued K1 operands of ``groups`` data-parallel groups over a
    [c, d] table in ``shards`` shards: random slots (psum), slots whose
    hits all lie on one shard (the static path's contract), and per group
    either one home shard's slots or random ones (the dynamic path)."""
    rng = np.random.default_rng(seed)
    rps = c // shards
    ls = shards - 1
    homes = np.array([g % shards if g % 2 == 0 else -1
                      for g in range(groups)], np.int32)
    n_hits = min(rps, s0 // 2)
    case = {"table": rng.integers(-8, 9, (c, d)).astype(np.float32),
            "streamed": rng.integers(-8, 9, (groups, s0, d)).astype(
                np.float32),
            "idx": rng.integers(0, s0, (groups, b, k)).astype(np.int32),
            "w": rng.integers(-3, 4, (groups, b, k)).astype(np.float32),
            "slots": np.stack([_slots(rng, s0, s0 // 2, 0, c)
                               for _ in range(groups)]),
            "slots_ls": np.stack([_slots(rng, s0, n_hits, ls * rps,
                                         (ls + 1) * rps)
                                  for _ in range(groups)]),
            "local_shard": ls, "local_shards": homes}
    case["slots_dyn"] = np.stack([
        _slots(rng, s0, n_hits, h * rps, (h + 1) * rps) if h >= 0
        else case["slots"][g] for g, h in enumerate(homes)])
    return case


def _k3_case(seed, exact, rows=32, d=8, bsz=24, k=4):
    """K3's operands over a ``rows``-row CSR.  ``exact``: every row has at
    most k cached neighbors (all taken), hit probability 1 and a degree
    that is a power of two, so every weight is 1/deg exactly and the sums
    of integer rows are exact."""
    rng = np.random.default_rng(seed)
    n_c = rng.integers(0, k + 1 if exact else 3 * k, rows)
    indptr = np.concatenate([[0], np.cumsum(n_c)]).astype(np.int32)
    indices = rng.integers(0, rows, int(indptr[-1])).astype(np.int32)
    if exact:
        deg = (2.0 ** rng.integers(0, 4, rows)).astype(np.float32)
        hitp = np.ones(rows, np.float32)
        table = rng.integers(-8, 9, (rows, d)).astype(np.float32)
    else:
        deg = rng.integers(1, 20, rows).astype(np.float32)
        hitp = rng.uniform(0.05, 1.0, rows).astype(np.float32)
        table = rng.normal(size=(rows, d)).astype(np.float32)
    dst = rng.integers(-1, rows, bsz).astype(np.int32)
    fb_rows = np.where(dst[:, None] < 0, rng.integers(-1, rows, (bsz, k)),
                       -1).astype(np.int32)
    fb_w = np.where(fb_rows >= 0, rng.integers(1, 4, (bsz, k)),
                    0).astype(np.float32)
    return {"indptr": indptr, "indices": indices, "deg": deg, "hitp": hitp,
            "table": table, "dst": dst, "fb_rows": fb_rows, "fb_w": fb_w,
            "key": np.array([[3, 5]], np.uint32)}


@pytest.fixture(scope="module")
def cases():
    return {"1x4": _lookup_case(1, groups=1, shards=4),
            "2x2": _lookup_case(2, groups=2, shards=2, c=16, s0=20, b=6,
                                k=3),
            "k3_exact": _k3_case(3, exact=True),
            "k3_rand": _k3_case(4, exact=False)}


# ---------------------------------------------------------------------------
# the reference's sharded op, on 4 forced host devices
# ---------------------------------------------------------------------------

REF_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.kernels.ops import cache_lookup_agg
from repro.sampling.adjacency import DeviceCacheAdj
from repro.sampling.kernels import gns_sample_agg

src, dst = sys.argv[1], sys.argv[2]
flat = dict(np.load(src))
cases = {}
for key, val in flat.items():
    name, field = key.split("/", 1)
    cases.setdefault(name, {})[field] = val
devs = np.asarray(jax.devices())
assert len(devs) == 4, devs
meshes = {"1x4": Mesh(devs.reshape(1, 4), ("data", "model")),
          "2x2": Mesh(devs.reshape(2, 2), ("data", "model"))}
out = {}

def glob(c, field):
    return jnp.asarray(np.concatenate(list(c[field])))

def lookup(c, mesh, slots, **kw):
    return cache_lookup_agg(jnp.asarray(c["table"]), glob(c, "streamed"),
                            glob(c, slots), glob(c, "idx"), glob(c, "w"),
                            mesh=mesh, shard_axis="model", **kw)

for name, mesh in meshes.items():
    c = cases[name]
    ls, homes = int(c["local_shard"]), c["local_shards"]
    out[f"{name}/psum"] = lookup(c, mesh, "slots")
    out[f"{name}/static"] = lookup(c, mesh, "slots_ls", local_shard=ls)
    out[f"{name}/dynamic"] = lookup(c, mesh, "slots_dyn", local_shards=homes)
    out[f"{name}/dynamic_off"] = lookup(c, mesh, "slots",
                                        local_shards=np.full_like(homes, -1))

c, mesh = cases["2x2"], meshes["2x2"]
for path, slots, kw in (("psum", "slots", {}),
                        ("static", "slots_ls",
                         {"local_shard": int(c["local_shard"])})):
    def loss(tbl, st, ww):
        o = cache_lookup_agg(tbl, st, glob(c, slots), glob(c, "idx"), ww,
                             mesh=mesh, shard_axis="model", **kw)
        return (o ** 2).sum()
    gt, gs, gw = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(c["table"]), glob(c, "streamed"), glob(c, "w"))
    out[f"grad/{path}/table"] = gt
    out[f"grad/{path}/streamed"] = gs
    out[f"grad/{path}/w"] = gw

mesh4 = Mesh(devs, ("model",))
for name in ("k3_exact", "k3_rand"):
    c = cases[name]
    adj = DeviceCacheAdj(*(jnp.asarray(c[f])
                           for f in ("indptr", "indices", "deg", "hitp")))
    args = (adj, jnp.asarray(c["table"]), jnp.asarray(c["dst"]),
            jnp.asarray(c["fb_rows"]), jnp.asarray(c["fb_w"]),
            jnp.asarray(c["key"]))
    out[name] = gns_sample_agg(*args, impl="reference", mesh=mesh4,
                               shard_axis="model")
    out[name + "/single"] = gns_sample_agg(*args, impl="reference")
np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(cases, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ops")
    src, dst = tmp / "cases.npz", tmp / "ref.npz"
    np.savez(src, **{f"{name}/{field}": np.asarray(val)
                     for name, case in cases.items()
                     for field, val in case.items()})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_CODE, str(src),
                           str(dst)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=SPAWN_S)
    assert proc.returncode == 0 and "REF_OK" in proc.stdout, \
        proc.stderr[-4000:]
    return dict(np.load(dst))


@pytest.fixture(scope="module")
def port(cases):
    """The port's ranks: a 1x4 world, in which each rank also builds the
    2x2 mesh.  One dict per rank."""
    return run_ranks("_torch_mesh_ranks:ops_ranks", data=1, model=4,
                     devices=["cpu"] * 4, backend="gloo", args=(cases,),
                     timeout_s=SPAWN_S)


def _rank_rows(name, rank, rows):
    """This rank's data-parallel group's rows of a collated array."""
    d = rank // 2 if name == "2x2" else 0
    return slice(d * rows, (d + 1) * rows)


# ---------------------------------------------------------------------------
# in-process: the shard maps, the partials, K3's row range
# ---------------------------------------------------------------------------

def test_shard_maps_match_reference():
    rng = np.random.default_rng(0)
    slots = rng.integers(-1, 32, (50, 7)).astype(np.int32)
    w = rng.normal(size=(50, 7)).astype(np.float32)
    for shard in range(4):
        np.testing.assert_array_equal(
            k1_port.shard_slot_map(torch.from_numpy(slots), shard, 8).numpy(),
            np.asarray(k1_ref.shard_slot_map(slots, shard, 8)))
        np.testing.assert_array_equal(
            k1_port.shard_lane_weights(torch.from_numpy(w),
                                       torch.from_numpy(slots), shard,
                                       8).numpy(),
            np.asarray(k1_ref.shard_lane_weights(w, slots, shard, 8)))


@pytest.mark.parametrize("claim_all", [False, True])
def test_shard_partials_match_reference(cases, claim_all):
    """Each shard's partial, bitwise the reference's; without ``claim_all``
    they sum to the single-device op, with it the owner's is the whole."""
    c = cases["1x4"]
    slots = c["slots_ls" if claim_all else "slots"][0]
    args = (c["streamed"][0], slots, c["idx"][0], c["w"][0])
    targs = [torch.from_numpy(a) for a in args]
    total = 0
    for shard in range(4):
        local = c["table"][shard * 8:(shard + 1) * 8]
        got = k1_port.cache_lookup_agg_shard_partial(
            torch.from_numpy(local), *targs, shard, 8,
            claim_all=claim_all).numpy()
        want = np.asarray(k1_ref.cache_lookup_agg_shard_partial(
            local, *args, shard, 8, use_kernel=False, claim_all=claim_all))
        np.testing.assert_array_equal(got, want)
        total = total + got
    single = k1_port.cache_lookup_agg_plain(
        torch.from_numpy(c["table"]), *targs).numpy()
    if claim_all:
        owner = k1_port.cache_lookup_agg_shard_partial(
            torch.from_numpy(c["table"][24:32]), *targs, 3, 8,
            claim_all=True).numpy()
        np.testing.assert_array_equal(owner, single)
    else:
        np.testing.assert_array_equal(total, single)


def _k3_args(c):
    adj = DeviceCacheAdj(*(torch.from_numpy(c[f])
                           for f in ("indptr", "indices", "deg", "hitp")))
    return adj, [torch.from_numpy(c[f]) for f in ("dst", "fb_rows", "fb_w")]


@pytest.mark.parametrize("name", ["k3_exact", "k3_rand"])
def test_k3_row_range(cases, name):
    """The default row range is the PR-21 call (the merged lanes through
    ``slot_gather_agg_plain``) bit for bit; an empty range gives zeros; one
    row reads only that row; and the partials of four ranges sum to the
    full call (bitwise on the exact case, where every product and sum is
    exact)."""
    c = cases[name]
    adj, (dst, fb_rows, fb_w) = _k3_args(c)
    table = torch.from_numpy(c["table"])
    full = k3_port.gns_sample_agg_plain(adj, table, dst, fb_rows, fb_w,
                                        c["key"])
    lanes = k3_port.sample_lanes_plain(adj, dst, fb_rows, fb_w, c["key"])
    assert torch.equal(full, slot_gather_agg_plain(table, *lanes))
    assert torch.equal(full, k3_port.gns_sample_agg_plain(
        adj, table, dst, fb_rows, fb_w, c["key"], row_lo=0, row_count=32))
    empty = k3_port.gns_sample_agg_plain(adj, table[:0], dst, fb_rows, fb_w,
                                         c["key"], row_lo=5, row_count=0)
    assert torch.equal(empty, torch.zeros_like(full))
    one = k3_port.gns_sample_agg_plain(adj, table[7:8], dst, fb_rows, fb_w,
                                       c["key"], row_lo=7, row_count=1)
    rows, w = lanes
    want_one = ((rows == 7) * w).sum(1, keepdim=True) * table[7]
    torch.testing.assert_close(one, want_one, rtol=1e-6, atol=1e-6)
    parts = sum(k3_port.gns_sample_agg_plain(
        adj, table[lo:lo + 8], dst, fb_rows, fb_w, c["key"], row_lo=lo,
        row_count=8) for lo in range(0, 32, 8))
    if name == "k3_exact":
        assert torch.equal(parts, full)
    else:
        torch.testing.assert_close(parts, full, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# across ranks: the port's sharded op against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("path", PATHS)
def test_sharded_lookup_matches_reference(cases, ref, port, mesh, path):
    """Every rank's rows equal its group's rows of the reference's sharded
    op, bit for bit (and so every shard of a group gives the same rows)."""
    b = cases[mesh]["idx"].shape[1]
    want = ref[f"{mesh}/{path}"]
    for rank, out in enumerate(port):
        np.testing.assert_array_equal(out[f"{mesh}/{path}"],
                                      want[_rank_rows(mesh, rank, b)])


@pytest.mark.parametrize("path", ["psum", "static"])
def test_sharded_lookup_grads_match_reference(cases, ref, port, path):
    """The mesh backward at 2x2: each rank's ``dcache`` is its shard's rows
    of the reference's (summed over the groups), ``dstreamed`` and ``dw``
    its group's rows; the static path shares the psum path's backward."""
    c = cases["2x2"]
    rps = c["table"].shape[0] // 2
    s0, b = c["streamed"].shape[1], c["idx"].shape[1]
    tol = dict(rtol=1e-5, atol=1e-5)
    for rank, out in enumerate(port):
        m = rank % 2
        np.testing.assert_allclose(out[f"grad/{path}/table"],
                                   ref[f"grad/{path}/table"][
                                       m * rps:(m + 1) * rps], **tol)
        np.testing.assert_allclose(out[f"grad/{path}/streamed"],
                                   ref[f"grad/{path}/streamed"][
                                       _rank_rows("2x2", rank, s0)], **tol)
        np.testing.assert_allclose(out[f"grad/{path}/w"],
                                   ref[f"grad/{path}/w"][
                                       _rank_rows("2x2", rank, b)], **tol)
        if path == "static":
            for f in ("table", "streamed", "w"):
                np.testing.assert_array_equal(out[f"grad/static/{f}"],
                                              out[f"grad/psum_ls/{f}"])


@pytest.mark.parametrize("name", ["k3_exact", "k3_rand"])
def test_k3_mesh_branch_matches_reference(ref, port, name):
    """K3 over each shard's row range, all-reduced, against the reference's
    mesh branch (a global draw, a per-shard gather, a psum): bit for bit
    where every product is exact, else within 1e-6."""
    for out in port:
        if name == "k3_exact":
            np.testing.assert_array_equal(out[name], ref[name])
            np.testing.assert_array_equal(out[name], ref[name + "/single"])
        else:
            np.testing.assert_allclose(out[name], ref[name], rtol=1e-6,
                                       atol=1e-6)


def test_launcher_fails_the_run_when_a_rank_raises():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks("_torch_mesh_ranks:raise_on_rank_1", data=2, model=1,
                  devices=["cpu"] * 2, backend="gloo", timeout_s=SPAWN_S)
