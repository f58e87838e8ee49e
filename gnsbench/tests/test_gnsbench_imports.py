"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's ``repro_torch`` is allowed, the
JAX package ``repro`` is not), and nothing reads ``benchmarks/``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from gnsbench import harness

BENCH = harness.BENCH_DIR
ROOT = BENCH.parent


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _imports(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "flops.py", "data.py", "trace.py"):
        assert "repro_torch" not in _imports(BENCH / name), name


def test_nothing_reads_the_old_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "\"benchmarks\"" not in text, \
            path


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.gns", "jaxtyping", "reproduce"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.gns", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.gns"]


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A tiny cell run end to end in a fresh process, then its modules."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from pathlib import Path\n"
        "from gnsbench import harness\n"
        "from gnsbench.tests._tiny import tiny_root\n"
        f"tmp = Path({str(tmp_path)!r})\n"
        "out, _ = harness.run_cell('tiny.train', 3, 0.3, False, 'cpu',\n"
        "    root=tiny_root(tmp))\n"
        "print(json.dumps([out['correct'],\n"
        "    harness.forbidden_modules(sys.modules)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    correct, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct and bad == []
