"""The invariant linter's port (``seldon_core_tpu_torch/analysis`` and
``tools/lint.py``) against the JAX package's.

- Every commit-point, phase-registry and registry-drift test of
  ``tests/test_lint.py`` runs with its ``lint_sources`` wrapped: each
  fixture goes through both linters, which must give the same findings
  (rule, line, symbol) of those three families, and the JAX test's own
  assertions then hold on the answer.
- A second ``stat_steps`` writer and a ``_pending_admits.clear()``
  seeded into the port's own ``serving/decode_scheduler.py`` are caught as
  CP001 and CP003; a direct ``_replica_states`` write in the port's
  ``serving/affinity_router.py`` as CP004.
- The port's tree is clean under ``lint-baseline-torch.json``.
- The CLI's exit codes and ``--json`` schema are the JAX CLI's.

Pure ``ast``: neither torch nor JAX is imported on this path.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from seldon_core_tpu.analysis import lint_sources as jax_lint_sources
from seldon_core_tpu_torch.analysis import Baseline, lint_paths, lint_sources, rule_catalogue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "seldon_core_tpu_torch")
FAMILIES = ("CP", "RD", "PH")


def _jax_lint_tests():
    spec = importlib.util.spec_from_file_location("jax_test_lint", os.path.join(REPO, "tests", "test_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TESTS = _jax_lint_tests()
SHARED = sorted(
    name for name in vars(JAX_TESTS)
    if name.startswith(("test_commit_point_", "test_registry_", "test_phase_registry_"))
    or name in ("test_inline_suppression_semantics", "test_baseline_split_and_stale")
)


def triples(findings) -> list:
    return [(f.rule, f.line, f.symbol) for f in findings if f.rule.startswith(FAMILIES)]


def test_shared_tests_cover_every_family():
    assert len(SHARED) == 19
    assert {n.split("_")[1] for n in SHARED} == {"commit", "registry", "phase", "inline", "baseline"}


@pytest.mark.parametrize("name", SHARED)
def test_fixture_findings_match_jax(name, monkeypatch):
    seen = []

    def both(sources, rules=None):
        theirs = jax_lint_sources(sources, rules=rules)
        ours = lint_sources(sources, rules=rules)
        assert triples(ours) == triples(theirs), (sources, rules)
        seen.append(len(theirs))
        return theirs

    monkeypatch.setattr(JAX_TESTS, "lint_sources", both)
    getattr(JAX_TESTS, name)()
    assert seen, f"{name} linted no fixture"


def test_catalogue_is_the_three_ported_passes():
    cat = rule_catalogue()
    assert set(cat) == {"commit-point", "registry-drift", "phase-registry"}
    assert set(cat["commit-point"]) == {"CP001", "CP002", "CP003", "CP004"}
    assert set(cat["registry-drift"]) == {"RD001", "RD002", "RD003"}
    assert set(cat["phase-registry"]) == {"PH001", "PH002"}
    with pytest.raises(ValueError):
        lint_sources({"m.py": "X = 1\n"}, rules=["trace-safety"])


def _port_source(rel: str) -> str:
    with open(os.path.join(PKG, *rel.split("/"))) as f:
        return f.read()


def test_seeded_stat_steps_second_writer_in_the_port_scheduler():
    src = _port_source("serving/decode_scheduler.py")
    assert lint_sources({"serving/decode_scheduler.py": src}, rules=["commit-point"]) == []
    marker = "        self.stat_spec_dispatches += 1"
    assert marker in src
    seeded = src.replace(marker, marker + "\n        self.stat_steps += 1", 1)
    findings = lint_sources({"serving/decode_scheduler.py": seeded}, rules=["commit-point"])
    assert [f.rule for f in findings] == ["CP001"]
    assert "stat_steps" in findings[0].message
    assert findings[0].symbol == "DecodeScheduler._consume_spec"


def test_seeded_pending_admits_writer_in_the_port_scheduler():
    src = _port_source("serving/decode_scheduler.py")
    marker = "        self.stat_retired += 1"
    assert marker in src
    seeded = src.replace(marker, marker + "\n        self._pending_admits.clear()", 1)
    findings = lint_sources({"serving/decode_scheduler.py": seeded}, rules=["commit-point"])
    assert [f.rule for f in findings] == ["CP003"]
    assert "_pending_admits" in findings[0].message


def test_seeded_replica_state_write_in_the_port_router():
    src = _port_source("serving/affinity_router.py")
    assert lint_sources({"serving/affinity_router.py": src}, rules=["commit-point"]) == []
    marker = "    def replica_states(self)"
    assert marker in src
    seeded = src.replace(marker, "    def _bypass(self, arm):\n        self._replica_states[arm] = 'down'\n\n"
                         + marker, 1)
    findings = lint_sources({"serving/affinity_router.py": seeded}, rules=["commit-point"])
    # a subscripted store reports twice, as in the JAX pass (the Subscript
    # and its Attribute are both walked)
    assert {(f.rule, f.symbol) for f in findings} == {("CP004", "ReplicatedDecodeScheduler._bypass")}


def test_port_tree_is_clean_under_its_baseline():
    findings = lint_paths([PKG], root=REPO)
    bl = Baseline.load(os.path.join(REPO, "lint-baseline-torch.json"))
    new, old, stale = bl.split(findings)
    assert new == [], "non-baselined lint findings:\n" + "\n".join(f.render() for f in new)
    assert stale == [], f"stale lint-baseline-torch.json entries: {stale}"
    # each waiver is one the JAX package's baseline makes for the same name
    with open(os.path.join(REPO, "lint-baseline.json")) as f:
        jax_waivers = {(e["rule"], e["symbol"]) for e in json.load(f)["entries"]}
    assert {(e["rule"], e["symbol"]) for e in bl.entries} <= jax_waivers
    assert len(old) == len(bl.entries)


def _cli(package: str, args: list, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", f"{package}.tools.lint", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_cli_matches_jax(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    bad = tmp_path / "bad.py"
    bad.write_text('import os\nY = os.environ.get("ENGINE_FLIGHT")\n')
    bl = tmp_path / "bl.json"
    cases = [
        [str(clean)],
        [str(bad)],
        [str(bad), "--json"],
        ["/no/such/path.py"],
        [str(bad), "--rules", "bogus"],
        [str(bad), "--no-baseline"],
    ]

    def pair(args):
        return _cli("seldon_core_tpu_torch", args, tmp_path), _cli("seldon_core_tpu", args, tmp_path)

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(pair, cases))
    for args, (ours, theirs) in zip(cases, results):
        assert ours.returncode == theirs.returncode, (args, ours.stderr, theirs.stderr)
    assert [r[0].returncode for r in results] == [0, 1, 1, 2, 2, 1]
    ours, theirs = (json.loads(r.stdout) for r in results[2])
    assert set(ours) == set(theirs)
    assert set(ours["counts"]) == set(theirs["counts"])
    assert [set(f) for f in ours["findings"]] == [set(f) for f in theirs["findings"]]
    assert triples_from_json(ours) == triples_from_json(theirs) == [("RD001", 2, "ENGINE_FLIGHT")]
    assert "bad.py:2:" in results[1][0].stdout and "clean" in results[0][0].stdout

    # the baseline round trip
    assert _cli("seldon_core_tpu_torch", [str(bad), "--write-baseline", str(bl)], tmp_path).returncode == 0
    r = _cli("seldon_core_tpu_torch", [str(bad), "--baseline", str(bl)], tmp_path)
    assert r.returncode == 0 and "baselined" in r.stdout


def triples_from_json(obj: dict) -> list:
    return [(f["rule"], f["line"], f["symbol"]) for f in obj["findings"]]


def test_cli_clean_on_the_port():
    r = _cli("seldon_core_tpu_torch", [], REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint: clean" in r.stdout
