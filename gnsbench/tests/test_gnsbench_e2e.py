"""A tiny cell run end to end on the CPU through the harness, with the
chip's look skipped: ``correct`` holds on the sound program and comes out
false with each fault the cell can have planted in its timed path."""
import math

import numpy as np
import pytest
import torch

from gnsbench import faults, harness
from gnsbench.tests._tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, seed, traced=False, seconds=0.5):
    return harness.run_cell("tiny.train", seed, seconds, traced, "cpu",
                            root=root)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_sound_run_is_correct(root, seed):
    out, lines = _run(root, seed)
    assert out["correct"], lines
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_nodes_per_s", "setup_s"}
    assert out["metrics"]["train_nodes_per_s"]["value"] > 0
    assert list(out)[-1] == "compared"
    assert [ln.split()[1] for ln in lines] == list(out["compared"])


def test_traced_run_reports_the_layers(root):
    out, _ = _run(root, 9, traced=True)
    assert out["correct"]
    got = out["metrics"]
    for name in ("train.prefetch_wait_share", "train.sample_ms",
                 "train.cache_hit_share", "train.refresh_share",
                 "train.h2d_bytes_per_node", "train.copy_host_ms"):
        assert name in got and math.isfinite(got[name]["value"]), name
    # no device on the CPU: the device readers find nothing to read
    assert "train.device_idle" not in got
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_k3_work_is_counted_on_the_window_s_own_generation(root):
    """The traced window records its first steps' K3 inputs; the
    refresh at the window's epoch draws a generation of its own, and K3's
    bound is worked out against it."""
    cell = harness.load_cell("tiny.train", root)
    ds, _, engine, rec = harness.setup(cell, 5, torch.device("cpu"))
    run = harness.window(engine, cell, 0.5, True)
    steps = run.k3_steps
    assert 0 < len(steps) == min(harness.K3_STEPS, run.steps)
    assert not np.array_equal(steps[0]["members"],
                              rec["steps"][0]["members"])
    bound = harness.k3_bound_ms(steps, ds, cell,
                                harness.cache_probs(ds, cell))
    assert math.isfinite(bound) and bound > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_makes_the_run_incorrect(root, fault):
    with faults.FAULTS[fault]():
        out, lines = _run(root, 7)
    assert not out["correct"], lines
