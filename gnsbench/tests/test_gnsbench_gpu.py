"""On the card: the control (the reference in TF32 in the program's place)
comes out not correct, and the program correct, at a size a test run
holds: ogbn-products' widths, batch and fanouts over 60,000 nodes."""
import pytest
import torch

from gnsbench import harness
from gnsbench.tests._tiny import TINY_TRAFFIC, tiny_root

DATA = {"nodes": 60_000, "avg_degree": 51, "feat_dim": 100,
        "num_classes": 47, "train_frac": 0.1, "val_frac": 0.02,
        "alpha": 2.1, "p_in": 0.8, "feature_noise": 1.5, "data_seed": 1}
TRAFFIC = dict(TINY_TRAFFIC, batch_size=1000, cache_fraction=0.01)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_and_program_holds(tmp_path, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_root(tmp_path, DATA, TRAFFIC)
    cell = harness.load_cell("tiny.train", root)
    cell.config["model"]["hidden_dim"] = 256
    dev = torch.device("cuda:0")
    ds, weights, engine, rec = harness.setup(cell, seed, dev)
    del engine
    limits = cell.workload["limits"]
    prog, _ = harness.check(ds, cell, weights, rec, dev)
    ctl, _ = harness.check(ds, cell, weights, rec, dev, tf32=True)
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(ctl[k] > limits[k] for k in limits), ctl
