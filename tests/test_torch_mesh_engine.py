"""Port parity of DP > 1 and the sharded cache at the engine level.

The port's engine on a ``(data, model)`` mesh runs one process per rank
(``gloo`` ranks spawned by ``repro_torch.launch.mesh.run_ranks``).  Its
oracle is the single-process form of the same run: without a mesh, on the
CPU, one torch thread, fed the reference's ``collate_groups`` batch of all
groups with ``SageConfig(num_groups=G)`` — the reference's own DP regime,
which runs on jax 0.9 only at the op level (its engine's mesh path raises
in ``graphsage.assemble_input``; ROADMAP Queue C).  The host pieces that
regime rests on (``collate_groups``, ``EpochLoader(dp_groups=)``,
``hash_partition``) are held bitwise to the reference in-process.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_mesh_ranks import engine_config, generation_numpy  # noqa: E402
from _torch_mesh_ranks import params_numpy  # noqa: E402
from _torch_parity import assert_batches_equal  # noqa: E402
from repro.core import sampler as samp_ref  # noqa: E402
from repro.core.pipeline import EpochLoader as LoaderRef  # noqa: E402
from repro.featurestore import CacheConfig as CacheRef  # noqa: E402
from repro.gns.engine import collate_groups as collate_ref  # noqa: E402
from repro.graph import partition as part_ref  # noqa: E402
from repro.graph.generate import powerlaw_graph as powerlaw_ref  # noqa: E402
from repro_torch.core import sampler as samp_port  # noqa: E402
from repro_torch.core.pipeline import EpochLoader  # noqa: E402
from repro_torch.featurestore import CacheConfig as CachePort  # noqa: E402
from repro_torch.gns import GNSEngine  # noqa: E402
from repro_torch.gns.engine import collate_groups  # noqa: E402
from repro_torch.graph import partition as part_port  # noqa: E402
from repro_torch.graph.datasets import get_dataset  # noqa: E402
from repro_torch.graph.generate import powerlaw_graph  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import graphsage  # noqa: E402

SPAWN_S = 300          # deadline of one spawn of ranks
TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 2


@pytest.fixture(scope="module")
def ds():
    return get_dataset("tiny", seed=0)


def _loaders(ds, groups=2, batch=32, **cache):
    """The reference's and the port's GNS sampler + EpochLoader, same
    config and seed."""
    out = []
    for mod, cache_cls, loader, kw in (
            (samp_ref, CacheRef, LoaderRef, {}),
            (samp_port, CachePort, EpochLoader, {"device": "cpu"})):
        cfg = mod.SamplerConfig(fanouts=(2, 3), batch_size=batch,
                                cache=cache_cls(fraction=0.05, **cache))
        s = mod.make_sampler("gns", ds.graph, cfg, ds.features, ds.labels,
                             train_idx=ds.train_idx, **kw)
        out.append(loader(s, ds.train_idx, seed=3, max_batches=4,
                          dp_groups=groups))
    return out


# ---------------------------------------------------------------------------
# in-process: the host pieces, bitwise to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 3, 4])
def test_hash_partition_matches_reference(hosts):
    g_ref = powerlaw_ref(700, avg_degree=6, seed=2)
    g_port = powerlaw_graph(700, avg_degree=6, seed=2)
    want = part_ref.hash_partition(g_ref, hosts)
    got = part_port.hash_partition(g_port, hosts)
    assert len(got) == len(want) == hosts
    for pr, pp in zip(want, got):
        assert (pr.host_id, pr.num_hosts) == (pp.host_id, pp.num_hosts)
        for f in ("owned", "local_indptr", "local_indices"):
            np.testing.assert_array_equal(getattr(pp, f), getattr(pr, f))
        np.testing.assert_array_equal(pp.owner_of(pp.owned),
                                      pr.owner_of(pr.owned))
    assert part_port.cache_refresh_traffic_bytes(1000, 100, hosts) == \
        part_ref.cache_refresh_traffic_bytes(1000, 100, hosts)


@pytest.mark.parametrize("fused", [False, True])
def test_collate_groups_matches_reference(ds, fused):
    """Two groups' batches of one round, collated: every array and the
    home-shard vector bit for bit."""
    ref, port = _loaders(ds, shards=2)
    want = list(ref.epoch(0))
    got = list(port.epoch(0))
    assert len(got) == len(want) == 4
    for i in (0, 2):
        mb_r, home_r = collate_ref(want[i:i + 2], fused)
        mb_p, home_p = collate_groups(got[i:i + 2], fused)
        assert_batches_equal(mb_r, mb_p)
        np.testing.assert_array_equal(home_p, home_r)


def test_epoch_loader_yields_its_groups_batches(ds):
    """``group=g`` yields batches g, g+G, ... of the all-groups loader, bit
    for bit (the batch RNG is keyed by batch index, never by rank), and a
    loader below one round raises, as the reference's."""
    _, port = _loaders(ds)
    every = list(port.epoch(0))
    for g in (0, 1):
        sampler = _loaders(ds)[1].sampler      # a fresh one per loader
        loader = EpochLoader(sampler, ds.train_idx, seed=3,
                             max_batches=4, dp_groups=2, group=g)
        mine = list(loader.epoch(0))
        assert len(mine) == 2
        for mb, want in zip(mine, every[g::2]):
            assert_batches_equal(want, mb)
    with pytest.raises(ValueError, match="full round"):
        list(EpochLoader(port.sampler, ds.train_idx, seed=3, max_batches=1,
                         dp_groups=2).epoch(0))


# ---------------------------------------------------------------------------
# the oracle: one process, no mesh, the collated batch of every group
# ---------------------------------------------------------------------------

def _oracle(spec: dict, groups: int):
    """The single-process run of ``spec``: ``STEPS`` steps, each on the
    collated batch of ``groups`` groups' minibatches.  Returns the engine
    and its per-epoch loss (the mean over steps)."""
    cfg = engine_config({k: v for k, v in spec.items() if k != "mesh"})
    cfg = dataclasses.replace(cfg, cache=dataclasses.replace(
        cfg.cache, shards=spec["mesh"][1]))
    ds = get_dataset(cfg.data.name, scale=cfg.data.scale, seed=cfg.data.seed)
    mcfg = graphsage.SageConfig(
        feat_dim=ds.feat_dim, hidden_dim=cfg.model.hidden_dim,
        num_classes=ds.num_classes, num_layers=2,
        input_impl=cfg.model.input_impl, num_groups=groups)
    eng = GNSEngine(cfg, device="cpu", dataset=ds, model_cfg=mcfg)
    loader = EpochLoader(eng.sampler, ds.train_idx, seed=eng.seed,
                         max_batches=STEPS * groups, dp_groups=groups)
    losses, buf = [], []
    for mb in loader.epoch(0):
        buf.append(mb)
        if len(buf) == groups:
            step, _ = collate_groups(buf, fused=False)
            losses.append(eng.run_batch(step)[0])
            buf = []
    return eng, float(np.mean(losses))


@pytest.fixture(scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SPECS_2 = [
    {"mesh": (2, 1), "input": "fused", "steps": STEPS},
    {"mesh": (1, 2), "input": "fused", "steps": STEPS, "eval": True},
    {"mesh": (1, 2), "input": "where", "backend": "device", "steps": STEPS,
     "eval": True},
    {"mesh": (2, 1), "input": "fused", "steps": STEPS, "epochs": 3,
     "async": True, "prefetch": True, "strategy": "adaptive"},
]


@pytest.fixture(scope="module")
def two_ranks():
    """A 2-rank world that runs ``SPECS_2`` in turn, each on its own mesh.
    One list per rank."""
    return run_ranks("_torch_mesh_ranks:engine_ranks", data=2, model=1,
                     devices=["cpu"] * 2, backend="gloo", args=(SPECS_2,),
                     timeout_s=SPAWN_S)


def _assert_ranks_agree(outs):
    """Every rank ends with the same parameters, bit for bit."""
    for out in outs[1:]:
        for a, b in zip(out["params"], outs[0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_fit_at_data_2_matches_the_collated_oracle(two_ranks, one_thread):
    """DP over 2 groups: each rank's loss is its group's NLL sum over the
    label count of both groups, the gradients are summed over the data
    group — the collated single-process run's loss and update, within
    1e-5."""
    outs = [r[0] for r in two_ranks]
    _assert_ranks_agree(outs)
    eng, loss = _oracle(SPECS_2[0], groups=2)
    np.testing.assert_allclose(outs[0]["losses"], [loss], **TOL)
    for a, b in zip(outs[0]["params"], params_numpy(eng)):
        np.testing.assert_allclose(a, b, **TOL)
    assert outs[0]["describe"]["shards"] == 1


@pytest.mark.parametrize("which", [1, 2], ids=["fused", "device"])
def test_fit_on_two_shards_matches_one_device(two_ranks, one_thread, which):
    """The cache in 2 shards (K1 per shard, or K3 over each shard's rows,
    partials all-reduced): losses, parameters, accuracy and ``infer``
    within 1e-5 of the same config on one device; each rank uploads half
    the table."""
    spec = SPECS_2[which]
    outs = [r[which] for r in two_ranks]
    _assert_ranks_agree(outs)
    eng, loss = _oracle(spec, groups=1)
    np.testing.assert_allclose(outs[0]["losses"], [loss], **TOL)
    for a, b in zip(outs[0]["params"], params_numpy(eng)):
        np.testing.assert_allclose(a, b, **TOL)
    assert outs[0]["val_acc"] == pytest.approx(eng.evaluate(num_batches=1),
                                               abs=1e-6)
    np.testing.assert_allclose(outs[0]["infer"],
                               eng.infer(eng.ds.val_idx[:20]), **TOL)
    table = generation_numpy(eng)["table"]
    rps = table.shape[0] // 2
    for m, out in enumerate(outs):
        np.testing.assert_array_equal(out["generation"]["table"],
                                      table[m * rps:(m + 1) * rps])
        rec = out["describe"]
        assert (rec["shards"], rec["rows_per_shard"]) == (2, rps)
        assert rec["upload_bytes_per_rank"] * 2 == \
            rec["upload_bytes_per_rank_replicated"]
        assert out["upload"] == out["uploads"] * rec["upload_bytes_per_rank"]


LOCALITY = {"mesh": (2, 2), "input": "fused", "placement": "locality",
            "steps": STEPS, "seed": 1}


@pytest.fixture(scope="module")
def four_ranks():
    return run_ranks("_torch_mesh_ranks:locality_ranks", data=2, model=2,
                     devices=["cpu"] * 4, backend="gloo", args=(LOCALITY,),
                     timeout_s=SPAWN_S)


def test_fit_at_2x2_matches_the_collated_oracle(four_ranks, one_thread):
    _assert_ranks_agree(four_ranks)
    eng, loss = _oracle(LOCALITY, groups=2)
    np.testing.assert_allclose(four_ranks[0]["losses"], [loss], **TOL)
    for a, b in zip(four_ranks[0]["params"], params_numpy(eng)):
        np.testing.assert_allclose(a, b, **TOL)


def test_locality_refresh_gives_every_rank_one_generation(four_ranks,
                                                          one_thread):
    """After an epoch in which each rank saw only its group's requests, a
    refresh merges every group's: all ranks build the generation that the
    single-process store, which saw every group's requests, builds — the
    same members, placement (not the identity: the traffic moved rows)
    and version — and each rank holds its shard's rows of its table."""
    eng, _ = _oracle(LOCALITY, groups=2)
    eng.sampler.refresh_cache(np.random.default_rng(5), version=7)
    want = generation_numpy(eng)
    assert want["placement"] is not None
    assert not np.array_equal(want["placement"],
                              np.arange(len(want["placement"])))
    rps = want["table"].shape[0] // 2
    for rank, out in enumerate(four_ranks):
        got = out["refreshed"]
        np.testing.assert_array_equal(got["node_ids"], want["node_ids"])
        np.testing.assert_array_equal(got["placement"], want["placement"])
        assert got["version"] == want["version"] == 7
        m = rank % 2
        np.testing.assert_array_equal(got["table"],
                                      want["table"][m * rps:(m + 1) * rps])
        assert sorted(out["group_hist"]) == sorted(eng.meter.group_hist)
        for g, h in eng.meter.group_hist.items():
            np.testing.assert_array_equal(out["group_hist"][g], h)


def test_async_refresh_swaps_at_one_step_on_every_rank(two_ranks):
    """Async refresh with prefetch and the adaptive policy at data=2: each
    build runs on its rank's own thread and finishes when it does, but the
    ranks swap at the same step and build from the same merged traffic —
    so after 3 epochs they hold one generation and bitwise-equal
    parameters."""
    outs = [r[3] for r in two_ranks]
    _assert_ranks_agree(outs)
    assert outs[0]["swaps"] == outs[1]["swaps"] >= 2
    for f in ("node_ids", "table"):
        np.testing.assert_array_equal(outs[0]["generation"][f],
                                      outs[1]["generation"][f])
    assert outs[0]["generation"]["version"] == \
        outs[1]["generation"]["version"]
    assert np.isfinite(outs[0]["losses"]).all()
