"""The port's roofline layer (``repro_torch/roofline``, ``kernels/
probe_ctx.py``, the collectives recorder) against the reference's.

* ``total_params``, ``active_params`` and ``model_flops`` bit for bit for
  every arch × shape; ``roofline_terms`` at the reference's ``V5E`` field
  by field;
* ``collective_bytes(log)`` against ``collective_bytes_from_hlo`` over
  HLO lines built from the same entries (five op types, groups 1-16);
* ``mha_ref`` under ``linear_attention_traffic`` within 1e-6 of the
  reference's stand-in, and single-token decode unchanged bit for bit;
* the step counter's FLOPs, bytes and peak bytes on small ops, and the
  H100's two collective tiers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import probe_ctx as jprobe  # noqa: E402
from repro.kernels.ref import mha_ref as jmha  # noqa: E402
from repro.roofline import analysis as jra  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import probe_ctx  # noqa: E402
from repro_torch.kernels.ref import mha_ref  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402

ARCHS = jconfigs.list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_bit_for_bit(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert ra.total_params(cfg) == jra.total_params(jcfg)
    assert ra.active_params(cfg) == jra.active_params(jcfg)
    for name, shape in jconfigs.SHAPES.items():
        assert ra.model_flops(cfg, configs.SHAPES[name]) == \
            jra.model_flops(jcfg, shape), name
        assert ra.model_flops(cfg, configs.SHAPES[name], n_active=1.5e9) \
            == jra.model_flops(jcfg, shape, n_active=1.5e9)


def _hlo_line(op: str, nbytes: int, group: int, i: int) -> str:
    """One post-SPMD HLO line of ``op`` with an f32 result of ``nbytes``
    and a replica group of ``group`` devices."""
    n = nbytes // 4
    ids = ",".join(str(r) for r in range(group))
    return (f"  %{op}.{i} = f32[{n}]{{0}} {op}(f32[{n}]{{0}} %p.{i}), "
            f"replica_groups={{{{{ids}}}}}")


OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


@pytest.mark.parametrize("group", [1, 2, 4, 16])
def test_collective_bytes_match_the_hlo_parser(group):
    log, lines = [], []
    for i, op in enumerate(OPS):
        for j, nbytes in enumerate((4096, 12 * 1024, 1 << 20)):
            log.append({"op": op, "bytes": nbytes, "group": group,
                        "spans_nodes": False, "site": "x:1"})
            lines.append(_hlo_line(op, nbytes, group, 10 * i + j))
    want = jra.collective_bytes_from_hlo("\n".join(lines))
    got = ra.collective_bytes(log)
    for op in OPS:
        assert got[op] == want[op], op
    assert got["total"] == want["total"]
    assert got["nvlink_bytes"] == want["total"] and got["network_bytes"] == 0


def test_roofline_terms_at_v5e_field_by_field():
    coll = {"total": 123456789}
    for arch in ("qwen2-7b", "deepseek-v2-236b", "xlstm-125m"):
        for name in ("train_4k", "decode_32k"):
            args = (3.5e12, 7.25e10, coll)
            want = jra.roofline_terms(*args, jconfigs.get_config(arch),
                                      jconfigs.SHAPES[name], 256,
                                      n_active=2.0e9).as_dict()
            got = ra.roofline_terms(*args, configs.get_config(arch),
                                    configs.SHAPES[name], 256, hw=ra.V5E,
                                    n_active=2.0e9).as_dict()
            assert got == want


def test_h100_collective_term_has_two_tiers():
    log = [{"op": "all-reduce", "bytes": 8 << 20, "group": 8,
            "spans_nodes": False, "site": "a:1"},
           {"op": "all-gather", "bytes": 16 << 20, "group": 16,
            "spans_nodes": True, "site": "b:2"}]
    coll = ra.collective_bytes(log)
    nv = 2 * (8 << 20) * 7 // 8
    net = (16 << 20) * 15 // 16
    assert (coll["nvlink_bytes"], coll["network_bytes"]) == (nv, net)
    t = ra.roofline_terms(1e12, 1e9, coll, configs.get_config("gemma-2b"),
                          configs.SHAPES["train_4k"], 16)
    assert t.collective_s == pytest.approx(nv / 450e9 + net / 50e9,
                                           rel=1e-12)
    assert ra.spans_nodes(range(8)) is False
    assert ra.spans_nodes([6, 7, 8]) is True


def _qkv(seed, sq, sk, hq=4, hkv=2, dh=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, hq, sq, dh)).astype(np.float32),
            rng.normal(size=(2, hkv, sk, dh)).astype(np.float32),
            rng.normal(size=(2, hkv, sk, dh)).astype(np.float32))


@pytest.mark.parametrize("sq,sk", [(6, 6), (5, 12)])
def test_linear_attention_stand_in_matches_the_reference(sq, sk):
    q, k, v = _qkv(0, sq, sk)
    with jprobe.linear_attention_traffic():
        want = np.asarray(jmha(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True))
    with probe_ctx.linear_attention_traffic():
        got = mha_ref(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), causal=True).numpy()
    # 1e-6 of the output's scale: both sum the same f32 products in
    # another order (measured: 1.1e-6 on outputs up to 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    assert not probe_ctx.linear_attention_on()


def test_single_token_decode_keeps_the_real_path_bit_for_bit():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 9))
    plain = mha_ref(q, k, v, causal=True, kv_len=7)
    with probe_ctx.linear_attention_traffic():
        probed = mha_ref(q, k, v, causal=True, kv_len=7)
    assert torch.equal(plain, probed)


def test_step_counter_flops_bytes_and_peak():
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    with ra.StepCounter() as c:
        y = a @ b                         # mm: 2·8·16·4 FLOPs
        z = y * 2.0                       # elementwise: 0 FLOPs
        del y
        w = z.view(32)                    # a view moves nothing
    assert c.flops == 2 * 8 * 16 * 4
    assert c.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4 + (8 * 4 * 2) * 4
    assert c.peak_bytes == 2 * 8 * 4 * 4 and w.shape == (32,)


def test_step_counter_is_the_same_on_meta_as_on_the_cpu():
    def step(dev):
        x = torch.ones(4, 8, device=dev, requires_grad=True)
        w = torch.ones(8, 8, device=dev, requires_grad=True)
        with ra.StepCounter() as c:
            for _ in range(3):            # repeats hit the meta cache
                loss = torch.relu(x @ w).sum()
                loss.backward()
        return c.as_dict()
    assert step("meta") == step("cpu")


def test_recorder_logs_op_bytes_group_and_site():
    from repro_torch.launch.mesh import dryrun_mesh
    from repro_torch.launch.sharding import use_mesh
    from repro_torch.models.common import full_logits
    with dryrun_mesh((2, 4), rank=5) as mesh, use_mesh(mesh):
        x = torch.empty(3, 16, device="meta")
        assert full_logits(x, 64).shape == (3, 64)       # nothing recorded
        with collectives.recording() as log:
            y = full_logits(x, 64)
            collectives.all_reduce(x, mesh.group("data"))
    assert collectives.current_log() is None and y.shape == (3, 64)
    site = log[0].pop("site")
    assert site.startswith("models/common.py:")
    assert log[0] == {"op": "all-gather", "bytes": 3 * 64 * 4, "group": 4,
                      "spans_nodes": False}
    assert log[1]["op"] == "all-reduce" and log[1]["group"] == 2
    assert log[1]["bytes"] == 3 * 16 * 4 and log[1]["site"] == "?"
