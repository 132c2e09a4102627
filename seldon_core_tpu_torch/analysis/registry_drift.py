"""RD*: the three registries the port centralizes, held at zero drift.

Port of ``seldon_core_tpu/analysis/registry_drift.py``.

- RD001: an OWNED env-var name (``ENGINE_*``, ``SELDON_TPU_*``,
  ``PREDICTIVE_UNIT_*``, ``SELDON_DEPLOYMENT_*``, ``LOADTEST_*``,
  ``TEST_CLIENT_*``, ``PERSISTENCE_*``) read from ``os.environ`` /
  ``os.getenv`` as a raw string literal outside utils/env.py. Raw reads
  are how the registry drifted to ~10 call sites historically — a typo'd
  name fails silently to the default. External names (``KUBERNETES_*``,
  ``CUDA_VISIBLE_DEVICES``, ``TORCH_*``) are not ours to register and are ignored.
- RD002: a ``seldon_tpu_*`` metric name minted outside
  metrics/registry.py — dashboards/alerts key on these strings, so every
  spelling must live in the one registry file (docstrings exempt).
- RD003: a ``TpuSpec`` knob (graph/spec.py) that graph/validation.py
  never mentions — config that validation cannot reject drifts into
  "silently ignored". Deliberately unconstrained knobs are acknowledged
  in validation.py's ``UNCONSTRAINED_KNOBS`` tuple, which counts as a
  mention.
"""

from __future__ import annotations

import ast
import re

from seldon_core_tpu_torch.analysis.core import ParsedFile, Project
from seldon_core_tpu_torch.analysis.model import Finding

OWNED_ENV_PREFIXES = (
    "ENGINE_",
    "SELDON_TPU_",
    "PREDICTIVE_UNIT_",
    "SELDON_DEPLOYMENT_",
    "LOADTEST_",
    "TEST_CLIENT_",
    "PERSISTENCE_",
)
METRIC_PREFIX = "seldon_tpu_"
ENV_REGISTRY = "utils/env.py"
METRIC_REGISTRY = "metrics/registry.py"
SPEC_FILE = "graph/spec.py"
VALIDATION_FILE = "graph/validation.py"


def _docstring_nodes(tree: ast.Module) -> set[int]:
    """ids of Constant nodes that are docstrings (exempt from RD002)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                out.add(id(body[0].value))
    return out


def _is_environ_read(pf: ParsedFile, call_or_sub: ast.AST) -> ast.expr | None:
    """The key expression when the node reads the process environment:
    os.environ[k] / os.environ.get(k,...) / os.getenv(k,...) /
    environ.get(k) after `from os import environ`."""

    def is_environ(e: ast.expr) -> bool:
        if isinstance(e, ast.Attribute) and e.attr == "environ":
            return isinstance(e.value, ast.Name) and pf.import_mod.get(
                e.value.id
            ) == "os"
        if isinstance(e, ast.Name):
            return pf.import_from.get(e.id) == ("os", "environ")
        return False

    if isinstance(call_or_sub, ast.Subscript) and is_environ(call_or_sub.value):
        return call_or_sub.slice
    if isinstance(call_or_sub, ast.Call):
        f = call_or_sub.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in ("get", "setdefault", "pop")
            and is_environ(f.value)
            and call_or_sub.args
        ):
            return call_or_sub.args[0]
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "getenv"
            and isinstance(f.value, ast.Name)
            and pf.import_mod.get(f.value.id) == "os"
            and call_or_sub.args
        ):
            return call_or_sub.args[0]
        if (
            isinstance(f, ast.Name)
            and pf.import_from.get(f.id) == ("os", "getenv")
            and call_or_sub.args
        ):
            return call_or_sub.args[0]
    return None


class RegistryDriftPass:
    name = "registry-drift"
    rules = {
        "RD001": "owned env name read raw outside utils/env.py",
        "RD002": "seldon_tpu_* metric name minted outside metrics/registry.py",
        "RD003": "TpuSpec knob with no graph/validation.py rule",
    }

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for pf in project.files:
            # the analysis package itself spells the rule patterns out
            linter_self = "/analysis/" in f"/{pf.path}"
            if not pf.path.endswith(ENV_REGISTRY) and not linter_self:
                self._check_env(pf, findings)
            if not pf.path.endswith(METRIC_REGISTRY) and not linter_self:
                self._check_metrics(pf, findings)
        self._check_knobs(project, findings)
        return findings

    # ------------------------------------------------------------ RD001
    def _check_env(self, pf: ParsedFile, findings: list[Finding]) -> None:
        for node in ast.walk(pf.tree):
            key = _is_environ_read(pf, node)
            if (
                key is not None
                and isinstance(key, ast.Constant)
                and isinstance(key.value, str)
                and key.value.startswith(OWNED_ENV_PREFIXES)
            ):
                findings.append(
                    Finding(
                        rule="RD001",
                        path=pf.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f'raw environment read of "{key.value}" — owned '
                            "env names live as constants in utils/env.py"
                        ),
                        hint=(
                            "import the constant: `from seldon_core_tpu_torch.utils"
                            f".env import {key.value}`"
                        ),
                        symbol=key.value,
                    )
                )

    # ------------------------------------------------------------ RD002
    def _check_metrics(self, pf: ParsedFile, findings: list[Finding]) -> None:
        docstrings = _docstring_nodes(pf.tree)
        for node in ast.walk(pf.tree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and node.value.startswith(METRIC_PREFIX)
                and id(node) not in docstrings
            ):
                findings.append(
                    Finding(
                        rule="RD002",
                        path=pf.path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f'metric-namespace literal "{node.value}" outside '
                            "metrics/registry.py — dashboards key on these "
                            "strings; one registry file owns the spelling"
                        ),
                        hint=(
                            "register the series in metrics/registry.py and "
                            "call it through the Metrics facade"
                        ),
                        symbol=node.value,
                    )
                )

    # ------------------------------------------------------------ RD003
    def _check_knobs(self, project: Project, findings: list[Finding]) -> None:
        spec = next(
            (f for f in project.files if f.path.endswith(SPEC_FILE)), None
        )
        validation = next(
            (f for f in project.files if f.path.endswith(VALIDATION_FILE)), None
        )
        if spec is None or validation is None:
            return  # cross-file leg needs both sides in the lint set
        tpu = next(
            (
                n
                for n in ast.walk(spec.tree)
                if isinstance(n, ast.ClassDef) and n.name == "TpuSpec"
            ),
            None,
        )
        if tpu is None:
            return
        # identifiers are matched exactly; string constants are tokenized
        # on word boundaries, so a knob that is a PREFIX of another knob's
        # name inside an error message ("decode_slo" in "decode_slo_ttft_ms
        # must be >= 0") does not count as covered
        mentioned: set[str] = set()
        for node in ast.walk(validation.tree):
            if isinstance(node, ast.Attribute):
                mentioned.add(node.attr)
            elif isinstance(node, ast.Name):
                mentioned.add(node.id)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                mentioned.update(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", node.value))
        for stmt in tpu.body:
            if not (
                isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ):
                continue
            knob = stmt.target.id
            if knob not in mentioned:
                findings.append(
                    Finding(
                        rule="RD003",
                        path=spec.path,
                        line=stmt.lineno,
                        col=stmt.col_offset,
                        message=(
                            f"TpuSpec knob `{knob}` has no rule in "
                            "graph/validation.py — misconfiguration would be "
                            "silently ignored instead of rejected"
                        ),
                        hint=(
                            "add a validate_deployment check, or list the "
                            "knob in validation.py's UNCONSTRAINED_KNOBS "
                            "acknowledgment"
                        ),
                        symbol=knob,
                    )
                )
