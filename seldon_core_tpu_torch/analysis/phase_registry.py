"""PH*: the flight recorder's family/phase registries, held at zero drift.

Port of ``seldon_core_tpu/analysis/phase_registry.py``.

The flight recorder attributes each round by host phase (``PHASES`` /
``P_*``) and by dispatch family (``FAMILIES`` / ``F_*``); both
registries live in telemetry/flight.py and are consumed by the decode
scheduler's ``_timed_call(F_X, ...)`` / ``with self._phase(P_X):``
sites. Two drift modes matter (the registry-drift family's lesson
applied to the new registry):

- PH001: a ``_timed_call`` / ``_phase`` site whose first argument is not
  a registered ``F_*``/``P_*`` constant. A raw index compiles and runs
  fine — it just silently mis-attributes the round (or walks off the
  fixed array), and nothing downstream can tell.
- PH002: a registered constant that no site outside the registry module
  consumes. An uninstrumented phase/family reads as a permanently-zero
  column in every frame, aggregate, and health read-out — "this phase is
  free" when the truth is "this phase is not measured".
"""

from __future__ import annotations

import ast
import re

from seldon_core_tpu_torch.analysis.core import ParsedFile, Project
from seldon_core_tpu_torch.analysis.model import Finding

# the registry module: the file defining the FAMILIES/PHASES tuples
REGISTRY_SUFFIX = "telemetry/flight.py"
REGISTRY_TUPLES = ("FAMILIES", "PHASES")
_CONST_RE = re.compile(r"^[FP]_[A-Z0-9_]+$")
# call names whose FIRST argument must be a registry constant
TIMER_FUNCS = ("_timed_call", "_phase")


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_registry_const(arg: ast.expr) -> bool:
    if isinstance(arg, ast.Name):
        return _CONST_RE.match(arg.id) is not None
    if isinstance(arg, ast.Attribute):
        return _CONST_RE.match(arg.attr) is not None
    return False


class PhaseRegistryPass:
    name = "phase-registry"
    rules = {
        "PH001": "_timed_call/_phase site whose family/phase is not a registered F_*/P_* constant",
        "PH002": "registered F_*/P_* constant no instrumentation site consumes",
    }

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        registry = next(
            (f for f in project.files if f.path.endswith(REGISTRY_SUFFIX)),
            None,
        )
        for pf in project.files:
            # the analysis package itself spells the patterns out
            if "/analysis/" in f"/{pf.path}":
                continue
            self._check_sites(pf, findings)
        if registry is not None:
            self._check_unused(project, registry, findings)
        return findings

    # ------------------------------------------------------------ PH001
    def _check_sites(self, pf: ParsedFile, findings: list[Finding]) -> None:
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = _call_name(node)
            if fname not in TIMER_FUNCS or not node.args:
                continue
            arg = node.args[0]
            if _is_registry_const(arg):
                continue
            rendered = ast.unparse(arg) if hasattr(ast, "unparse") else "<expr>"
            findings.append(
                Finding(
                    rule="PH001",
                    path=pf.path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"`{fname}({rendered}, ...)` — the family/phase "
                        "argument must be a registered F_*/P_* constant "
                        "from telemetry/flight.py; a raw index silently "
                        "mis-attributes the round"
                    ),
                    hint=(
                        "import the constant: `from seldon_core_tpu_torch"
                        ".telemetry.flight import F_STEP` (or P_*) and "
                        "pass it by name"
                    ),
                    symbol=pf.qualname(node) or fname,
                )
            )

    # ------------------------------------------------------------ PH002
    def _check_unused(
        self, project: Project, registry: ParsedFile, findings: list[Finding]
    ) -> None:
        # only enforce when the registry file really is the flight module
        # shape (defines one of the registry tuples) — a fixture that
        # happens to end in the suffix without registries is left alone
        tuple_names = {
            t.id
            for stmt in registry.tree.body
            if isinstance(stmt, ast.Assign)
            for t in stmt.targets
            if isinstance(t, ast.Name)
        }
        if not tuple_names.intersection(REGISTRY_TUPLES):
            return
        defined: dict[str, int] = {}
        for stmt in registry.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            for target in stmt.targets:
                elts = target.elts if isinstance(target, ast.Tuple) else [target]
                for el in elts:
                    if isinstance(el, ast.Name) and _CONST_RE.match(el.id):
                        defined[el.id] = stmt.lineno
        if not defined:
            return
        used: set[str] = set()
        for pf in project.files:
            if pf is registry or "/analysis/" in f"/{pf.path}":
                continue
            for node in ast.walk(pf.tree):
                if (
                    isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in defined
                ):
                    used.add(node.id)
                elif isinstance(node, ast.Attribute) and node.attr in defined:
                    used.add(node.attr)
        for name in sorted(set(defined) - used):
            findings.append(
                Finding(
                    rule="PH002",
                    path=registry.path,
                    line=defined[name],
                    col=0,
                    message=(
                        f"registered constant `{name}` is never consumed "
                        "by an instrumentation site — its column is "
                        "permanently zero in every frame/aggregate/health "
                        "read-out, which reads as 'free' instead of 'not "
                        "measured'"
                    ),
                    hint=(
                        "instrument the phase/family (a `with self._phase("
                        f"{name}):` block or `_timed_call({name}, ...)` "
                        "site), or remove it from the registry"
                    ),
                    symbol=name,
                )
            )
