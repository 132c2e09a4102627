"""Finding/baseline/suppression model shared by every lint pass.

Port of ``seldon_core_tpu/analysis/model.py``.

A ``Finding`` is one defect at one source location. Identity for baseline
matching is (rule, path, symbol) — NOT the line number, so a checked-in
baseline survives unrelated edits above the finding. ``symbol`` is the
enclosing ``Class.method`` qualname when the finding sits inside one, else
the offending literal/name itself.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field

SEV_ERROR = "error"
SEV_WARNING = "warning"

# trailing-comment suppression: "# lint: ignore" (everything) or
# "# lint: ignore[TS001,CP002]" (listed rules only)
_IGNORE_RE = re.compile(r"#\s*lint:\s*ignore(?:\[([A-Za-z0-9_,\s]+)\])?")


@dataclass
class Finding:
    rule: str  # e.g. "TS001"
    path: str  # repo-relative posix path
    line: int  # 1-based
    col: int  # 0-based (ast convention)
    message: str
    hint: str = ""  # how to fix it, one line
    severity: str = SEV_ERROR
    symbol: str = ""  # enclosing qualname or offending literal

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def to_dict(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        if self.hint:
            out += f" [hint: {self.hint}]"
        return out


def parse_suppressions(source: str) -> dict[int, frozenset[str] | None]:
    """Map 1-based line -> suppressed rule set (None = every rule).

    Scans text lines rather than the token stream: a ``# lint: ignore``
    inside a string literal would be honored too, which is harmless (the
    marker is namespaced enough not to occur by accident) and keeps this
    O(lines) with no tokenizer dependency."""
    out: dict[int, frozenset[str] | None] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(text)
        if not m:
            continue
        rules = m.group(1)
        if rules is None:
            out[i] = None
        else:
            out[i] = frozenset(r.strip() for r in rules.split(",") if r.strip())
    return out


def suppressed(finding: Finding, marks: dict[int, frozenset[str] | None]) -> bool:
    mark = marks.get(finding.line)
    if mark is None and finding.line in marks:
        return True  # bare "# lint: ignore"
    return mark is not None and finding.rule in mark


@dataclass
class Baseline:
    """Checked-in deliberate exceptions. Each entry suppresses EVERY
    finding matching its (rule, path, symbol) triple — count-insensitive
    on purpose: the baseline records "this pattern here is accepted", not
    a brittle occurrence tally."""

    entries: list[dict] = field(default_factory=list)

    @staticmethod
    def load(path: str) -> "Baseline":
        with open(path) as f:
            obj = json.load(f)
        entries = obj.get("entries", []) if isinstance(obj, dict) else obj
        for e in entries:
            if not isinstance(e, dict) or not {"rule", "path", "symbol"} <= set(e):
                raise ValueError(
                    f"{path}: baseline entries need rule/path/symbol, got {e!r}"
                )
        return Baseline(entries=entries)

    @staticmethod
    def from_findings(findings: list[Finding]) -> "Baseline":
        seen: set[tuple[str, str, str]] = set()
        entries = []
        for f in findings:
            if f.key() in seen:
                continue
            seen.add(f.key())
            entries.append(
                {
                    "rule": f.rule,
                    "path": f.path,
                    "symbol": f.symbol,
                    "reason": "",
                }
            )
        return Baseline(entries=entries)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"version": 1, "entries": self.entries}, f, indent=2)
            f.write("\n")

    def _keys(self) -> set[tuple[str, str, str]]:
        return {(e["rule"], e["path"], e["symbol"]) for e in self.entries}

    def split(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding], list[dict]]:
        """(new, baselined, stale_entries): ``new`` fails the build,
        ``baselined`` is reported informationally, ``stale_entries`` are
        baseline rows that matched nothing (candidates for deletion)."""
        keys = self._keys()
        new = [f for f in findings if f.key() not in keys]
        old = [f for f in findings if f.key() in keys]
        hit = {f.key() for f in old}
        stale = [
            e
            for e in self.entries
            if (e["rule"], e["path"], e["symbol"]) not in hit
        ]
        return new, old, stale
