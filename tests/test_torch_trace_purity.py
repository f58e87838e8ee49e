"""The port's trace-purity pass and its two scalar retrace rules
(``repro_torch.analysis.trace_purity``, ``retrace``): given the roots the
reference's ``find_trace_roots`` returns, they give the reference's findings
exactly, on its fixtures and on ``src/repro`` (static findings are not
numbers); ``TRACE_ROOTS`` has one row for each reference root, each
resolving in the port with the reference's static names; every new rule
fires on the torch fixtures; the call graph follows ``Fn.apply``; and each
of the port's five line suppressions is what keeps its tree clean.
"""
import ast
import functools
import json
import shutil
from pathlib import Path

import pytest

from repro_torch.analysis import retrace, trace_purity
from repro_torch.analysis.__main__ import main, run_passes
from repro_torch.analysis.common import (TRACE_ROOTS, RepoIndex, TraceRoot,
                                         find_trace_roots,
                                         missing_trace_roots)

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PORT = SRC / "repro_torch"
FIXTURES = Path(__file__).parent / "analysis_fixtures_torch"
REF_FIXTURES = Path(__file__).parent / "analysis_fixtures"
BASELINE = REPO / ".github" / "gnscheck-torch-baseline.txt"

# the reference's root kinds under the port's names
KIND = {"jit": "step", "pallas": "kernel", "shard_map": "rank"}
TRACE_RULES = {"trace-nondeterminism", "trace-global-state",
               "trace-self-mutation", "trace-mutation", "trace-host-branch"}
SCALAR_RULES = {"retrace-scalar-arg", "retrace-scalar-flow"}


def _tuples(violations):
    return {(v.rule, v.path, v.line, v.symbol, v.detail) for v in violations}


@functools.lru_cache(maxsize=None)
def _reference_roots(root: Path, prefix: str):
    """The reference's ``find_trace_roots`` over ``root``: (its index, its
    roots, the same roots as the port's ``TraceRoot``s)."""
    from repro.analysis.common import RepoIndex as RefIndex
    from repro.analysis.common import find_trace_roots as ref_find
    ri = RefIndex(root, prefix)
    roots = ref_find(ri)
    port_roots = [TraceRoot(ref=r.ref, kind=KIND[r.kind],
                            site_path=r.site_path, site_line=r.site_line,
                            static_names=set(r.static_names),
                            static_nums=set(r.static_nums)) for r in roots]
    return ri, roots, port_roots


@pytest.fixture(scope="module")
def port_index():
    return RepoIndex(PORT)


@pytest.fixture(scope="module")
def fixture_violations():
    return run_passes(RepoIndex(FIXTURES,
                                package_prefix="analysis_fixtures_torch"))


# ---------------------------------------------------------------------------
# (a) parity: the reference's findings, exactly, on the reference's roots
# ---------------------------------------------------------------------------

PARITY = [(REF_FIXTURES, "analysis_fixtures"), (SRC / "repro", "repro")]


@pytest.mark.parametrize("root,prefix", PARITY, ids=["fixtures", "repro"])
@pytest.mark.parametrize("pass_name", ["trace_purity", "retrace"])
def test_passes_match_reference_on_its_roots(root, prefix, pass_name):
    from repro.analysis import retrace as rretrace
    from repro.analysis import trace_purity as rtrace
    ref_pass, port_pass = {"trace_purity": (rtrace, trace_purity),
                           "retrace": (rretrace, retrace)}[pass_name]
    ri, _, roots = _reference_roots(root, prefix)
    ref = _tuples(ref_pass.run(ri))
    port = _tuples(port_pass.run(RepoIndex(root, package_prefix=prefix),
                                 roots))
    assert port == ref
    if prefix == "repro":
        assert port == set()                  # 0 and 0 at HEAD
    else:
        rules = TRACE_RULES if pass_name == "trace_purity" else SCALAR_RULES
        assert {r for r, *_ in port} == rules


def test_reference_fixture_findings_are_the_documented_ones():
    _, _, roots = _reference_roots(REF_FIXTURES, "analysis_fixtures")
    index = RepoIndex(REF_FIXTURES, package_prefix="analysis_fixtures")
    got = {(r, s, d) for r, _p, _l, s, d in
           _tuples(trace_purity.run(index, roots) + retrace.run(index, roots))
           if r in TRACE_RULES | SCALAR_RULES}
    assert got == {
        ("trace-host-branch", "impure_step", "flag"),
        ("trace-nondeterminism", "impure_step", "random.random"),
        ("trace-nondeterminism", "impure_step", "time.perf_counter"),
        ("trace-mutation", "impure_step", "_EVENTS.append"),
        ("trace-global-state", "counting_step", "_COUNT"),
        ("trace-self-mutation", "Model._fwd", "self.calls"),
        ("retrace-scalar-arg", "stepper", "n_steps"),
        ("retrace-scalar-flow", "drive", "stepper:len(...)")}


# ---------------------------------------------------------------------------
# (b) the registry: one row per reference root, each resolving in the port
# ---------------------------------------------------------------------------

def _params(node: ast.AST) -> set:
    a = node.args
    return {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}


def test_every_reference_root_has_exactly_one_row():
    _, roots, _ = _reference_roots(SRC / "repro", "repro")
    refs = {r.ref for r in roots}
    assert len(refs) >= 19
    stands_for = [row[4] for row in TRACE_ROOTS]
    assert sorted(stands_for) == sorted(refs)


@pytest.mark.parametrize("row", TRACE_ROOTS, ids=[r[4] for r in TRACE_ROOTS])
def test_each_row_resolves_with_the_reference_statics(port_index, row):
    suffix, local, kind, static, ref = row
    _, roots, _ = _reference_roots(SRC / "repro", "repro")
    ref_roots = [r for r in roots if r.ref == ref]
    assert {KIND[r.kind] for r in ref_roots} == {kind}
    if suffix.startswith("csrc/"):
        assert (PORT / suffix).is_file()
        return
    fi = port_index.by_path[suffix].functions[local]
    ref_static = set().union(*(r.static_names for r in ref_roots))
    assert set(static) == ref_static & _params(fi.node)


def test_every_row_resolves_on_the_port(port_index):
    roots = find_trace_roots(port_index)
    assert len(roots) == len(TRACE_ROOTS)
    assert not missing_trace_roots(port_index)
    for r in roots:
        fi = port_index.func(r.ref)
        assert fi is not None and fi.node.lineno == r.site_line
        assert r.site_path == fi.module.path


def test_traced_region_is_at_least_the_references(port_index):
    ri, roots, _ = _reference_roots(SRC / "repro", "repro")
    ref_region = ri.reachable([r.ref for r in roots])
    region = port_index.reachable(
        [r.ref for r in find_trace_roots(port_index)])
    assert len(region) >= len(ref_region) >= 68


def test_a_lost_root_function_is_a_finding(tmp_path):
    src = (PORT / "models" / "moe.py").read_text()
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "moe.py").write_text(src)
    assert not trace_purity.run(RepoIndex(tmp_path))
    (tmp_path / "models" / "moe.py").write_text(
        src.replace("def moe_forward(", "def moe_forward_v2("))
    vs = trace_purity.run(RepoIndex(tmp_path))
    assert [(v.rule, v.symbol, v.detail) for v in vs] == [
        ("trace-root-missing", "moe_forward", "moe_forward:missing")]


# ---------------------------------------------------------------------------
# (c) every new rule fires on the torch fixtures; seeded draws stay clean
# ---------------------------------------------------------------------------

def test_every_new_rule_fires_on_the_torch_fixtures(fixture_violations):
    got = {(v.rule, v.path, v.symbol, v.detail) for v in fixture_violations
           if v.rule in TRACE_RULES | SCALAR_RULES | {"trace-root-missing"}}
    assert got == {
        ("trace-host-branch", "launch/steps.py",
         "make_train_step.train_step", "flag"),
        ("retrace-scalar-arg", "launch/steps.py",
         "make_train_step.train_step", "n_steps"),
        ("trace-nondeterminism", "launch/steps.py",
         "make_train_step.train_step", "torch.randn"),
        ("trace-nondeterminism", "launch/steps.py",
         "make_train_step.train_step", "noise.uniform_"),
        ("trace-nondeterminism", "launch/steps.py", "_Noisy.backward",
         "torch.rand_like"),
        ("trace-mutation", "launch/steps.py", "make_train_step.train_step",
         "_LOG.append"),
        ("trace-global-state", "launch/steps.py", "_bump", "_COUNT"),
        ("trace-self-mutation", "launch/serve.py", "ServeEngine._step",
         "self.steps"),
        ("trace-nondeterminism", "launch/serve.py", "ServeEngine._step",
         "torch.multinomial"),
        ("retrace-scalar-flow", "launch/serve.py", "ServeEngine.generate",
         "_step:int(...)"),
        ("trace-root-missing", "models/moe.py", "moe_forward",
         "moe_forward:missing")}


def test_a_draw_with_a_generator_does_not_fire(fixture_violations):
    flagged = {(v.path, v.line) for v in fixture_violations}
    for rel in ("launch/steps.py", "launch/serve.py"):
        lines = (FIXTURES / rel).read_text().splitlines()
        seeded = [n for n, text in enumerate(lines, 1)
                  if "generator=" in text and "torch.Generator" not in text]
        assert seeded
        assert not {(rel, n) for n in seeded} & flagged


def test_the_serve_steps_seeded_multinomial_stays_clean(port_index):
    fi = port_index.by_path["launch/serve.py"].functions["ServeEngine._step"]
    seg = ast.get_source_segment(
        "\n".join(fi.module.source_lines), fi.node)
    assert "torch.multinomial(" in seg and "generator=self._gen" in seg
    root = next(r for r in find_trace_roots(port_index)
                if r.ref == fi.qualname)
    assert not trace_purity._check_function(fi, fi.module, root)


# ---------------------------------------------------------------------------
# (d) Fn.apply reaches the autograd Function's forward and backward
# ---------------------------------------------------------------------------

def test_apply_reaches_forward_and_backward(port_index):
    ops = "repro_torch.kernels.ops"
    assert port_index.callees(f"{ops}:cache_lookup_agg") >= {
        f"{ops}:_CacheLookupAgg.forward", f"{ops}:_CacheLookupAgg.backward"}
    region = port_index.reachable(
        [r.ref for r in find_trace_roots(port_index)])
    coll = "repro_torch.launch.collectives"
    assert {f"{ops}:_CacheLookupAgg.forward", f"{ops}:_sharded_forward",
            f"{coll}:_Copy.backward", f"{coll}:_Reduce.forward",
            f"{coll}:_Gather.backward"} <= region


def test_apply_of_a_non_function_class_is_not_followed(tmp_path):
    (tmp_path / "m.py").write_text(
        "import torch\n"
        "class Fn(torch.autograd.Function):\n"
        "    @staticmethod\n"
        "    def forward(ctx, x):\n"
        "        return x\n"
        "class Plain:\n"
        "    def forward(self, x):\n"
        "        return x\n"
        "def a(x):\n"
        "    return Fn.apply(x)\n"
        "def b(x):\n"
        "    return Plain.apply(x)\n")
    index = RepoIndex(tmp_path, package_prefix="x")
    assert index.callees("x.m:a") == {"x.m:Fn.forward"}
    assert index.callees("x.m:b") == set()


# ---------------------------------------------------------------------------
# (e) each suppression is what keeps the tree clean
# ---------------------------------------------------------------------------

SUPPRESSED = [("kernels/_ext.py", "trace-global-state"),
              ("kernels/cache_lookup.py", "trace-mutation"),
              ("kernels/flash_attention.py", "trace-mutation"),
              ("kernels/gather_agg.py", "trace-mutation"),
              ("sampling/kernels.py", "trace-mutation")]


@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    """A copy of the port's sources, clean against the empty baseline."""
    copy = tmp_path_factory.mktemp("tree") / "repro_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "csrc"))
    assert main(["--root", str(copy), "--baseline", str(BASELINE)]) == 0
    return copy


@pytest.mark.parametrize("rel,rule", SUPPRESSED, ids=[s[0] for s in SUPPRESSED])
def test_taking_away_a_suppression_fails_the_cli(port_copy, capsys, rel,
                                                 rule):
    marker = f"  # gnscheck: ignore[{rule}]"
    src = (port_copy / rel).read_text()
    assert src.count(marker) == 1
    (port_copy / rel).write_text(src.replace(marker, ""))
    capsys.readouterr()
    try:
        rc = main(["--root", str(port_copy), "--baseline", str(BASELINE),
                   "--json"])
    finally:
        (port_copy / rel).write_text(src)
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert [(v["rule"], v["path"]) for v in out["new"]] == [(rule, rel)]
