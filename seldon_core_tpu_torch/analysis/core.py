"""Visitor core: parsed-project model, pass registry, runner.

Port of ``seldon_core_tpu/analysis/core.py``. Passes are project-scoped,
not file-scoped — registry-drift compares graph/spec.py against
graph/validation.py and phase-registry reads telemetry/flight.py beside
its users, so every pass receives the whole parsed ``Project``
and returns plain ``Finding`` lists. Suppression comments and the baseline
are applied centrally by the runner, never inside a pass.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from seldon_core_tpu_torch.analysis.model import Finding, parse_suppressions, suppressed


@dataclass
class ParsedFile:
    path: str  # repo-relative posix path (finding identity)
    module: str  # dotted module name best-effort ("" when unknown)
    source: str
    tree: ast.Module
    suppressions: dict[int, frozenset[str] | None] = field(default_factory=dict)
    # name -> (module, name) for "from m import n [as alias]";
    # alias -> module for "import m [as alias]"
    import_from: dict[str, tuple[str, str]] = field(default_factory=dict)
    import_mod: dict[str, str] = field(default_factory=dict)
    # simple name -> module-level (or nested) FunctionDef; parents map for
    # qualname reconstruction
    functions: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = field(
        default_factory=dict
    )
    parents: dict[ast.AST, ast.AST] = field(default_factory=dict)

    def qualname(self, node: ast.AST) -> str:
        """Dotted Class.method / function qualname for the innermost
        def/class enclosing ``node`` (baseline identity)."""
        names: list[str] = []
        cur: ast.AST | None = node
        while cur is not None:
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                names.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(names))


def _index_file(pf: ParsedFile) -> None:
    for parent in ast.walk(pf.tree):
        for child in ast.iter_child_nodes(parent):
            pf.parents[child] = parent
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                pf.import_from[alias.asname or alias.name] = (
                    node.module,
                    alias.name,
                )
        elif isinstance(node, ast.Import):
            for alias in node.names:
                pf.import_mod[alias.asname or alias.name] = alias.name
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # bare-name calls can never land on a class METHOD (those are
            # reached through self./cls.), so keeping methods out of the
            # table stops a method from shadowing a same-named module
            # helper and silently absorbing its call edges. Module-level
            # and nested defs both register; last definition wins, like
            # runtime rebinding would.
            if not isinstance(pf.parents.get(node), ast.ClassDef):
                pf.functions[node.name] = node


@dataclass
class Project:
    files: list[ParsedFile]
    by_module: dict[str, ParsedFile] = field(default_factory=dict)
    by_path: dict[str, ParsedFile] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for pf in self.files:
            if pf.module:
                self.by_module[pf.module] = pf
            self.by_path[pf.path] = pf

    def resolve_function(
        self, pf: ParsedFile, name: str
    ) -> tuple[ParsedFile, ast.FunctionDef | ast.AsyncFunctionDef] | None:
        """Resolve a simple call name inside ``pf`` to a function def in
        the analyzed set: local def first, then ``from m import name``."""
        node = pf.functions.get(name)
        if node is not None:
            return pf, node
        target = pf.import_from.get(name)
        if target is not None:
            mod, orig = target
            other = self.by_module.get(mod)
            if other is not None and orig in other.functions:
                return other, other.functions[orig]
        return None


def _module_name(abs_path: str) -> str:
    """Best-effort dotted module name: walk up while __init__.py exists."""
    parts = [os.path.splitext(os.path.basename(abs_path))[0]]
    d = os.path.dirname(abs_path)
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        nd = os.path.dirname(d)
        if nd == d:
            break
        d = nd
    name = ".".join(reversed(parts))
    return name[: -len(".__init__")] if name.endswith(".__init__") else name


def parse_file(abs_path: str, rel_path: str) -> ParsedFile | None:
    try:
        with open(abs_path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=rel_path)
    except (OSError, SyntaxError, ValueError):
        return None  # unparsable files are not this linter's business
    pf = ParsedFile(
        path=rel_path.replace(os.sep, "/"),
        module=_module_name(abs_path),
        source=source,
        tree=tree,
        suppressions=parse_suppressions(source),
    )
    _index_file(pf)
    return pf


def parse_source(path: str, source: str, module: str = "") -> ParsedFile:
    """Test/fixture entry: lint in-memory source under a virtual path."""
    pf = ParsedFile(
        path=path,
        module=module or os.path.splitext(os.path.basename(path))[0],
        source=source,
        tree=ast.parse(source, filename=path),
        suppressions=parse_suppressions(source),
    )
    _index_file(pf)
    return pf


def collect_py_files(paths: list[str], root: str) -> list[tuple[str, str]]:
    """(abs, rel) python files under ``paths``, skipping caches/protos."""
    out: list[tuple[str, str]] = []
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap):
            out.append((ap, os.path.relpath(ap, root)))
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(
                d for d in dirnames if d not in ("__pycache__", ".git")
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py") or fn.endswith("_pb2.py"):
                    continue
                fp = os.path.join(dirpath, fn)
                out.append((fp, os.path.relpath(fp, root)))
    return out


# --------------------------------------------------------------- registry
def _passes():
    # imported lazily so `import seldon_core_tpu_torch.analysis.model` (tests,
    # fixtures) never pays for every pass module
    from seldon_core_tpu_torch.analysis import (  # noqa: PLC0415
        commit_point,
        phase_registry,
        registry_drift,
    )

    return [
        commit_point.CommitPointPass(),
        registry_drift.RegistryDriftPass(),
        phase_registry.PhaseRegistryPass(),
    ]


ALL_PASSES = _passes


def rule_catalogue() -> dict[str, dict[str, str]]:
    """pass name -> {rule id -> one-line description} (docs + --rules)."""
    return {p.name: dict(p.rules) for p in _passes()}


def _select(rules: list[str] | None):
    selected = _passes()
    if rules:
        want = {r.strip().lower() for r in rules if r.strip()}
        selected = [
            p
            for p in selected
            if p.name in want
            or any(rid.lower() in want for rid in p.rules)
        ]
        if not selected:
            known = [p.name for p in _passes()]
            raise ValueError(f"no pass matches {sorted(want)}; known: {known}")
    return selected


def run_passes(
    project: Project, rules: list[str] | None = None
) -> list[Finding]:
    """Run (selected) passes and apply inline suppressions. When a rule
    subset is given, findings outside it are dropped even if the owning
    pass also reports other rules."""
    findings: list[Finding] = []
    only: set[str] | None = None
    if rules:
        only = {r.strip().upper() for r in rules if r.strip()}
    for p in _select(rules):
        for f in p.run(project):
            if only and f.rule not in only and p.name.upper() not in only:
                continue
            pf = project.by_path.get(f.path)
            if pf is not None and suppressed(f, pf.suppressions):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_paths(
    paths: list[str], root: str | None = None, rules: list[str] | None = None
) -> list[Finding]:
    root = os.path.abspath(root or os.getcwd())
    files = []
    for ap, rel in collect_py_files(paths, root):
        pf = parse_file(ap, rel)
        if pf is not None:
            files.append(pf)
    return run_passes(Project(files=files), rules=rules)


def lint_sources(
    sources: dict[str, str], rules: list[str] | None = None
) -> list[Finding]:
    """Fixture entry point: {virtual_path: source} -> findings. Module
    names are the file stems, so ``from a import f`` resolves against a
    fixture file named ``a.py``."""
    files = [parse_source(path, text) for path, text in sources.items()]
    return run_passes(Project(files=files), rules=rules)
