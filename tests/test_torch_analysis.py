"""The port's static analyzer (``repro_torch.analysis``): held to the
reference's lock and generation passes with exact equality (static findings
are not numbers; ``test_torch_trace_purity.py`` holds the trace and
retrace rules alike), every ported rule fires on its fixture, the torch meter
lint tells transfers from casts and allocations, the pad registry guards
the port's three padding idioms, and the CLI's exit codes and baseline
ratchet read alike in both packages.  The port's tree is clean against the
empty ``.github/gnscheck-torch-baseline.txt``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import baseline as pbl
from repro_torch.analysis import generation, locks, meterlint, retrace
from repro_torch.analysis.__main__ import main, run_passes, stats
from repro_torch.analysis.common import RepoIndex, Violation

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PORT = SRC / "repro_torch"
FIXTURES = Path(__file__).parent / "analysis_fixtures_torch"
REF_FIXTURES = Path(__file__).parent / "analysis_fixtures"
BASELINE = REPO / ".github" / "gnscheck-torch-baseline.txt"

PORT_RULES = {"lock-unguarded-write", "lock-unguarded-read",
              "lock-external-access", "gen-chained-read", "gen-multi-read",
              "gen-direct-private", "meter-unpaired-transfer",
              "retrace-pad-registry", "retrace-scalar-arg",
              "retrace-scalar-flow", "trace-nondeterminism",
              "trace-global-state", "trace-self-mutation", "trace-mutation",
              "trace-host-branch", "trace-root-missing"}

# the port's only line suppressions, each with its reason in the comment
# above it and in README's static-analysis section: eager-mode launch
# counters and the one-time kernel build, which a captured step must mend
SUPPRESSIONS = {("kernels/_ext.py", "trace-global-state"),
                ("kernels/cache_lookup.py", "trace-mutation"),
                ("kernels/flash_attention.py", "trace-mutation"),
                ("kernels/gather_agg.py", "trace-mutation"),
                ("sampling/kernels.py", "trace-mutation")}


def _tuples(violations):
    return {(v.rule, v.path, v.line, v.symbol, v.detail) for v in violations}


def _reference_tuples(violations):
    """The reference's findings under the port's rule names: it documents
    ``lock-external-access`` but reports an access through another object
    (detail ``obj.<attr>``; an access through ``self`` has detail
    ``<attr>``) as ``lock-unguarded-read``/``-write``."""
    out = set()
    for v in violations:
        rule = v.rule
        if rule.startswith("lock-unguarded-") and "." in v.detail:
            rule = "lock-external-access"
        out.add((rule, v.path, v.line, v.symbol, v.detail))
    return out


def _both(root: Path, prefix: str):
    """(port, reference) lock + generation findings over one root."""
    from repro.analysis import generation as rgen
    from repro.analysis import locks as rlocks
    from repro.analysis.common import RepoIndex as RefIndex
    pi, ri = RepoIndex(root, package_prefix=prefix), RefIndex(root, prefix)
    port = _tuples(locks.run(pi) + generation.run(pi))
    ref = _reference_tuples(rlocks.run(ri) + rgen.run(ri))
    return port, ref


@pytest.fixture(scope="module")
def fixture_violations():
    return run_passes(RepoIndex(FIXTURES,
                                package_prefix="analysis_fixtures_torch"))


@pytest.fixture(scope="module")
def port_index():
    return RepoIndex(PORT)


# ---------------------------------------------------------------------------
# locks and generation: the reference's findings, exactly
# ---------------------------------------------------------------------------

def test_lock_and_generation_match_reference_on_its_fixtures():
    port, ref = _both(REF_FIXTURES, "analysis_fixtures")
    assert port == ref
    assert {r for r, *_ in port} == {
        "lock-unguarded-write", "lock-unguarded-read",
        "lock-external-access", "gen-chained-read", "gen-multi-read",
        "gen-direct-private"}


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_lock_and_generation_match_reference_on_both_trees(package):
    port, ref = _both(SRC / package, package)
    assert port == ref
    assert port == set()          # both trees are clean (the port's since
                                  # the fabric's follower stop was repaired)


def test_both_analyzers_find_the_pre_repair_follower_stop(tmp_path):
    """The follower branch of ``ServeFabric.stop`` reaching into each
    worker's ``_thread`` (as it did before the repair) is found by both
    analyzers alike."""
    for rel in ("serve/fabric.py", "featurestore/store.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text((PORT / rel).read_text())
    fab = tmp_path / "serve" / "fabric.py"
    src = fab.read_text()
    repaired = ("            wd = self._watchdog\n"
                "            while not self._follow_errors and (\n")
    assert repaired in src
    fab.write_text(src.replace(repaired, (
        "            threads = [t for t in [self._watchdog]\n"
        "                       + [w._thread for w in self.workers]]\n"
        + repaired)))
    port, ref = _both(tmp_path, "repro_torch")
    assert port == ref
    assert {(r, s, d) for r, _p, _l, s, d in port} == {
        ("lock-external-access", "ServeFabric.stop", "w._thread")}


def test_reference_analyzer_is_clean_on_the_port():
    from repro.analysis.__main__ import main as ref_main
    assert ref_main(["--root", str(PORT)]) == 0


# ---------------------------------------------------------------------------
# every ported rule fires on its fixture; the clean twins stay clean
# ---------------------------------------------------------------------------

def test_every_port_rule_fires_on_the_fixtures(fixture_violations):
    assert {v.rule for v in fixture_violations} == PORT_RULES
    assert all(v.severity == "error" for v in fixture_violations)


def test_lock_rules_fire(fixture_violations):
    got = {(v.rule, v.symbol) for v in fixture_violations
           if v.path == "fx_locks.py" and v.rule.startswith("lock-")}
    assert got == {("lock-unguarded-write", "Store._refresh"),
                   ("lock-unguarded-read", "Store.peek"),
                   ("lock-unguarded-write", "Store.publish"),
                   ("lock-external-access", "poll")}


def test_generation_rules_fire(fixture_violations):
    vs = [v for v in fixture_violations if v.path == "fx_generation.py"
          and v.rule.startswith("gen-")]
    assert {(v.rule, v.symbol) for v in vs} == {
        ("gen-chained-read", "tearing_batch"),
        ("gen-multi-read", "tearing_batch"),
        ("gen-direct-private", "peek_buffers")}


def _meter_symbols(violations):
    return {v.symbol for v in violations
            if v.rule == "meter-unpaired-transfer"}


UNBOOKED = ("to", "to_device_kw", "to_string", "to_torch_device",
            "to_unclassified", "cuda", "as_tensor", "tensor", "copy",
            "copy_into_named")


@pytest.mark.parametrize("idiom", UNBOOKED)
def test_each_torch_transfer_idiom_fires_and_its_booked_twin_does_not(
        fixture_violations, idiom):
    flagged = _meter_symbols(fixture_violations)
    assert f"unbooked_{idiom}" in flagged
    assert f"booked_{idiom}" not in flagged


def test_a_meter_handed_in_but_unused_books_nothing(fixture_violations):
    assert "unbooked_handed_the_meter" in _meter_symbols(fixture_violations)


def test_casts_allocations_and_forwarded_devices_never_fire():
    index = RepoIndex(FIXTURES, package_prefix="analysis_fixtures_torch")
    sites = {t.symbol for t in meterlint.find_transfers(index)}
    assert not {s for s in sites if s.startswith("never_")}
    assert {f"unbooked_{i}" for i in UNBOOKED} <= sites


def test_the_trees_transfers_are_found_and_paired(port_index):
    sites = {(t.path, t.symbol): t for t in
             meterlint.find_transfers(port_index)}
    for key in (("featurestore/store.py", "FeatureStore._upload"),
                ("sampling/adjacency.py", "build_device_cache_adj"),
                ("gns/engine.py", "GNSEngine._put_batch")):
        assert key in sites and sites[key].paired, key
    assert all(t.paired for t in sites.values())
    # the dtype casts of sampling/kernels.py and rng.py are out of scope
    # and not transfers anyway
    assert not any(p.endswith(("kernels.py", "rng.py")) for p, _ in sites)


def test_put_batch_without_its_meter_line_is_flagged(tmp_path):
    src = (PORT / "gns" / "engine.py").read_text()
    line = "        meter.t_copy += time.perf_counter() - t0\n"
    assert src.count(line) == 1
    (tmp_path / "gns").mkdir()
    (tmp_path / "gns" / "engine.py").write_text(src)
    assert not meterlint.run(RepoIndex(tmp_path))
    (tmp_path / "gns" / "engine.py").write_text(src.replace(line, ""))
    vs = meterlint.run(RepoIndex(tmp_path))
    assert [(v.rule, v.symbol) for v in vs] == [
        ("meter-unpaired-transfer", "GNSEngine._put_batch")]


def test_suppression_comment(tmp_path):
    (tmp_path / "m.py").write_text(
        "def up(t):\n"
        "    a = t.cuda()  # gnscheck: ignore[meter-unpaired-transfer]\n"
        "    return a\n"
        "def up2(t):\n"
        "    return t.cuda()\n")
    vs = meterlint.run(RepoIndex(tmp_path, package_prefix="x"))
    assert [(v.symbol, v.line) for v in vs] == [("up2", 5)]


# ---------------------------------------------------------------------------
# the pad registry
# ---------------------------------------------------------------------------

def test_pad_registry_is_clean_on_the_port(port_index):
    assert not retrace.run(port_index)


# a replacement that keeps the module parseable but drops the idiom
STRIP = {"bit_length": "bit_count", "self.buckets": "self.ladder",
         "%": "//"}


@pytest.mark.parametrize("entry", retrace.PAD_REGISTRY,
                         ids=[e[1] for e in retrace.PAD_REGISTRY])
def test_pad_registry_guards_the_padding_idiom(tmp_path, port_index, entry):
    suffix, local, needle, _reason = entry
    real = PORT / suffix
    fi = port_index.by_path[suffix].functions[local]
    lines = real.read_text().splitlines(keepends=True)
    lo, hi = fi.node.lineno - 1, fi.node.end_lineno
    body = "".join(lines[lo:hi])
    assert needle in body
    out = tmp_path / suffix
    out.parent.mkdir(parents=True)
    out.write_text("".join(lines[:lo]) + body.replace(needle, STRIP[needle])
                   + "".join(lines[hi:]))
    vs = retrace.run(RepoIndex(tmp_path))
    assert [(v.rule, v.symbol, v.detail) for v in vs] == [
        ("retrace-pad-registry", local, f"{local}:{needle}")]
    assert needle in vs[0].message


# ---------------------------------------------------------------------------
# the CLI and the baseline ratchet
# ---------------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    assert main(["--root", str(FIXTURES)]) == 1
    assert main(["--root", str(tmp_path / "absent")]) == 2
    assert main(["--root", str(FIXTURES), "--write-baseline"]) == 2
    with pytest.raises(SystemExit) as exc:
        main(["--no-such-flag"])
    assert exc.value.code == 2
    # every finding baselined -> 0
    bl = tmp_path / "bl.txt"
    assert main(["--root", str(FIXTURES), "--baseline", str(bl),
                 "--write-baseline"]) == 0
    assert main(["--root", str(FIXTURES), "--baseline", str(bl)]) == 0
    entries = pbl.load(bl)
    assert len(entries) == 34
    # a new finding (its entry dropped) -> 1
    bl.write_text("".join(e + "\n" for e in entries[1:]))
    assert main(["--root", str(FIXTURES), "--baseline", str(bl)]) == 1
    # a stale entry (violation fixed but entry kept) -> 1
    bl.write_text("".join(e + "\n" for e in entries)
                  + "bogus-rule|gone.py|fn|x\n")
    assert main(["--root", str(FIXTURES), "--baseline", str(bl)]) == 1
    capsys.readouterr()


def test_baseline_keys_are_line_number_free(tmp_path):
    v1 = Violation("r", "p.py", 10, "f", "m", detail="d")
    v2 = Violation("r", "p.py", 99, "f", "m", detail="d")  # moved 89 lines
    assert v1.key() == v2.key()
    assert pbl.keyed([v1, v2]) == ["r|p.py|f|d", "r|p.py|f|d#2"]
    bl = tmp_path / "b.txt"
    pbl.write(bl, [v1, v2])
    assert pbl.load(bl) == sorted(["r|p.py|f|d", "r|p.py|f|d#2"])
    new, stale = pbl.compare([v2, v1], pbl.load(bl))
    assert not new and not stale


def test_either_packages_baseline_reads_alike_in_the_other(tmp_path):
    from repro.analysis import baseline as rbl
    from repro.analysis.common import Violation as RefViolation
    found = [("lock-external-access", "serve/fabric.py", 489,
              "ServeFabric.stop", "w._thread"),
             ("meter-unpaired-transfer", "gns/engine.py", 306,
              "GNSEngine._put_batch", "GNSEngine._put_batch"),
             ("meter-unpaired-transfer", "gns/engine.py", 310,
              "GNSEngine._put_batch", "GNSEngine._put_batch")]
    port = [Violation(r, p, n, s, "m", detail=d) for r, p, n, s, d in found]
    ref = [RefViolation(r, p, n, s, "m", detail=d)
           for r, p, n, s, d in found]
    assert pbl.keyed(port) == rbl.keyed(ref)
    for write, vs, compare, load, others in (
            (pbl.write, port, rbl.compare, rbl.load, ref),
            (rbl.write, ref, pbl.compare, pbl.load, port)):
        path = tmp_path / "bl.txt"
        assert write(path, vs) == 3
        assert compare(others, load(path)) == ([], [])
        new, stale = compare(others[:2], load(path))
        assert not new and len(stale) == 1          # a fixed repeat: stale


def test_the_port_is_clean_against_the_empty_baseline(port_index):
    assert pbl.load(BASELINE) == []
    assert BASELINE.read_text().startswith("# gnscheck baseline")
    new, stale = pbl.compare(run_passes(port_index), pbl.load(BASELINE))
    assert not new, "\n".join(v.render() for v in new)
    assert not stale
    # repaired, or suppressed at the line with a reason (the analyzer's
    # own docstrings name the comment)
    marks = [(mi, n) for mi in port_index.modules.values()
             if not mi.path.startswith("analysis/")
             for n in range(1, len(mi.source_lines) + 1)
             if mi.suppressed(n)]
    assert {(mi.path, rule) for mi, n in marks
            for rule in mi.suppressed(n)} == SUPPRESSIONS
    assert len(marks) == len(SUPPRESSIONS)
    readme = (REPO / "README.md").read_text()
    for mi, n in marks:
        assert mi.source_lines[n - 2].strip().startswith("#"), (mi.path, n)
        assert f"`{mi.path}`" in readme, mi.path


BLOCKED_RUN = r'''
import runpy, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "torch"):
            raise ImportError(f"the analyzer imported {name}")
        return None

sys.meta_path.insert(0, Blocker())
sys.argv = ["gnscheck"] + sys.argv[1:]
runpy.run_module("repro_torch.analysis", run_name="__main__")
'''


def test_cli_module_runs_clean_on_the_port_without_jax_repro_or_torch():
    """``python -m repro_torch.analysis`` as the smoke script runs it, with
    ``jax``, ``repro`` and even ``torch`` refused: the analyzer stands
    alone."""
    import json
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, "--baseline", str(BASELINE),
         "--json"], capture_output=True, text=True, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["violations"] == [] and out["new"] == []
    assert out["stale_baseline"] == []
    st = out["stats"]
    assert st["modules"] >= 90 and st["guarded_classes"] >= 14
    assert st["thread_entries"] >= 8
    assert st["transfers"] == st["paired_transfers"] >= 3
    # every reference trace root has a row; the region is at least the
    # reference's own (68 functions)
    assert st["trace_roots"] >= 19 and st["traced_functions"] >= 68


def test_stats_count_what_the_passes_walk():
    st = stats(RepoIndex(FIXTURES, package_prefix="analysis_fixtures_torch"))
    assert st == {"modules": 7, "guarded_classes": 1, "thread_entries": 1,
                  "transfers": 21, "paired_transfers": 10,
                  "trace_roots": 4, "traced_functions": 7}
