"""The harness finds cells, configurations, traffic and per-layer metrics
by their files alone, and ``BENCHMARK.json`` agrees with those files."""
import json
import shutil
import subprocess
import sys

from gnsbench import harness
from gnsbench.tests._tiny import tiny_root

ROOT = harness.BENCH_DIR.parent


def test_a_new_cell_config_and_metric_are_found_from_their_files(tmp_path):
    root = tiny_root(tmp_path)
    cell = harness.load_cell("tiny.train", root)
    assert cell.config["data"]["nodes"] == 3000
    assert cell.traffic["batch_size"] == 64
    (root / "metrics" / "train.new_metric.py").write_text(
        "UNIT = 'ms'\n\ndef read(run):\n    return 1.5\n")
    readers = harness.load_metrics(root)
    assert "train.new_metric" in readers
    assert readers["train.new_metric"].read(None) == 1.5
    assert set(harness.load_metrics()) <= set(readers)


def test_benchmark_json_matches_the_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "gnsbench/run.py"]
    assert bench["paths"] == ["gnsbench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert (ROOT / c["file"]).is_file()
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
    readers = harness.load_metrics()
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert cell.workload[key] == w[key], (w["name"], key)
        assert w["config"] in configs
    names = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].UNIT == m["unit"]
        assert set(m.get("workloads", names)) <= names
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "train_nodes_per_s"} <= e2e


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "gnsbench" / "run.py"), "--workload",
         "products.train.gns", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        return                       # on a card the run would proceed
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gnsbench", tmp_path / "gnsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "gnsbench/run.py", "--workload",
         "products.train.gns", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
