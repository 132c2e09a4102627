"""Invariant linter: AST static analysis for the port's own bug classes.

Port of ``seldon_core_tpu/analysis``. The serving tier rests on invariants
that unit tests can only check after the fact: the decode scheduler's
per-round state must funnel through one commit point, the flight
recorder's family/phase registries must match their instrumentation sites,
and the env/knob/metric registries (utils/env.py, graph/spec.py +
graph/validation.py, metrics/registry.py) drift silently as modules grow.
This package turns those invariants into review-time checks:

- ``commit_point``  (CP*): per-round scheduler state must funnel through
  ``_commit_round``/``_round_reset``; ``self.*`` state mutated on both
  sides of an ``await`` without a lock is an interleaving hazard; the
  pipelined rounds' ``_pending*`` shadow state and the fleet's
  ``_replica_states`` have one sanctioned writer set each.
- ``registry_drift`` (RD*): owned env names read outside utils/env.py,
  ``seldon_tpu_*`` metric names minted outside metrics/registry.py, and
  TpuSpec knobs with no graph/validation.py rule.
- ``phase_registry`` (PH*): every ``_timed_call``/``_phase`` site names a
  registered ``F_*``/``P_*`` flight constant, and every registered
  constant is consumed by at least one instrumentation site.

The JAX package's trace-safety (TS*) and ladder-coverage (LC*) passes read
``jax.jit`` programs; their counterparts for the port's CUDA graphs
(``ops/graphs.py::GraphCache``) are not written yet.

Pure stdlib (``ast``): no torch import, so the CLI and the tier-1 guard
test stay fast. CLI: ``python -m seldon_core_tpu_torch.tools.lint``.

Suppression: a trailing ``# lint: ignore[RULE,...]`` (or bare
``# lint: ignore``) comment silences findings on that line; deliberate
whole-tree exceptions live in the checked-in ``lint-baseline-torch.json``.
"""

from seldon_core_tpu_torch.analysis.core import (
    ALL_PASSES,
    Project,
    lint_paths,
    lint_sources,
    rule_catalogue,
)
from seldon_core_tpu_torch.analysis.model import Baseline, Finding

__all__ = [
    "ALL_PASSES",
    "Baseline",
    "Finding",
    "Project",
    "lint_paths",
    "lint_sources",
    "rule_catalogue",
]
