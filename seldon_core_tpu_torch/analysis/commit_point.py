"""CP*: commit-point discipline for per-round scheduler state.

Port of ``seldon_core_tpu/analysis/commit_point.py``, over the port's
``serving/decode_scheduler.py`` and ``serving/affinity_router.py``.

The drift class: a per-round stat (``stat_steps``) updated at two sites
(the spec and plain decode paths) can silently diverge; every per-round
commit goes through ONE ``_commit_round`` point instead. These rules keep
that invariant structural:

- CP001: in any class defining ``_commit_round``, an attribute that
  ``_commit_round`` mutates is ROUND-COMMITTED state — mutating it from
  any other method (``_round_reset`` and ``__init__`` excepted) recreates
  the two-site drift hazard.
- CP002: in an ``async`` method, writing the same ``self.*`` attribute on
  both sides of an ``await`` leaves a window where another coroutine
  observes (or interleaves its own write into) a half-updated invariant.
  Writes inside an ``async with self.<lock>`` block are exempt; loop
  bodies are walked linearly (no wrap-around), so a single write site
  inside a loop does not flag.
- CP003: the pipelined scheduler's SHADOW round state (``self._pending*``
  — admissions/input plans decided under an in-flight dispatch)
  gets the same single-writer discipline ``_commit_round`` state gets: in
  a class that defines the reconcile funnel (``_apply_pending``) or a
  pipeline builder (``_pipeline_*``), a ``_pending*`` attribute may be
  mutated ONLY by the builders (``_pipeline_*``), the reconcile funnel
  (``_apply_pending``), ``__init__``, and ``_round_reset``. A write from
  anywhere else — including mutating calls like ``.append``/``.clear``,
  which plain store analysis misses — re-opens the speculate-vs-commit
  drift the shadow state exists to prevent.
- CP004: the replica lifecycle funnel (``self._replica_states`` — the
  fleet's up/draining/evicted/down machine, serving/affinity_router.py)
  gets the same discipline: in a class that defines the transition funnel
  (``_set_replica_state``), the state list may be mutated ONLY by
  ``__init__`` and the funnel itself — eligibility flips, lifecycle
  metrics, and flight-recorder fields all hang off the transition, so a
  write from anywhere else ships a half-applied transition.
"""

from __future__ import annotations

import ast
import re

from seldon_core_tpu_torch.analysis.core import ParsedFile, Project
from seldon_core_tpu_torch.analysis.model import Finding

_EXEMPT_METHODS = ("__init__", "_commit_round", "_round_reset")

# CP003: sanctioned writers of self._pending* shadow state — the pipeline
# builders by prefix, the reconcile funnel, and the init/reset funnels
_PENDING_PREFIX = "_pending"
_PENDING_WRITER_PREFIX = "_pipeline_"
_PENDING_WRITERS = ("__init__", "_round_reset", "_apply_pending")
# method calls that mutate their receiver (list/deque/dict/set mutators) —
# a ``self._pending_x.append(...)`` is a shadow-state write even though no
# ast.Assign exists
_MUTATING_CALLS = frozenset(
    (
        "append", "appendleft", "extend", "extendleft", "insert", "remove",
        "pop", "popleft", "popitem", "clear", "add", "discard", "update",
        "setdefault", "sort", "reverse",
    )
)

# CP004: the replica lifecycle list and its single sanctioned funnel
_LIFECYCLE_ATTR = "_replica_states"
_LIFECYCLE_FUNNEL = "_set_replica_state"
_LIFECYCLE_WRITERS = ("__init__", _LIFECYCLE_FUNNEL)


def _self_attr_writes(stmt: ast.stmt) -> list[tuple[str, ast.AST]]:
    """(attr, node) for every ``self.X`` / ``self.X[...]`` store in one
    statement (no recursion into nested statements)."""
    out: list[tuple[str, ast.AST]] = []
    targets: list[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    for t in targets:
        for el in ast.walk(t):
            node = el
            if isinstance(node, ast.Starred):
                node = node.value
            if isinstance(node, ast.Subscript):
                node = node.value
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                out.append((node.attr, stmt))
    return out


def _pending_writes(fn: ast.AST) -> list[tuple[str, ast.AST]]:
    """(attr, node) for every mutation of a ``self._pending*`` attribute
    inside ``fn``: plain/aug/ann stores (via _self_attr_writes) plus
    mutating method calls (``self._pending_x.append(...)``)."""
    out: list[tuple[str, ast.AST]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.stmt):
            for attr, site in _self_attr_writes(node):
                if attr.startswith(_PENDING_PREFIX):
                    out.append((attr, site))
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _MUTATING_CALLS
                and isinstance(f.value, ast.Attribute)
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id == "self"
                and f.value.attr.startswith(_PENDING_PREFIX)
            ):
                out.append((f.value.attr, node))
    return out


class CommitPointPass:
    name = "commit-point"
    rules = {
        "CP001": "round-committed attribute mutated outside _commit_round/_round_reset",
        "CP002": "same self.* attribute written on both sides of an await without a lock",
        "CP003": "shadow/pending round state mutated outside the pipeline builders and _apply_pending",
        "CP004": "replica lifecycle state mutated outside the _set_replica_state funnel",
    }

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for pf in project.files:
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.ClassDef):
                    self._check_class(pf, node, findings)
        return findings

    # ------------------------------------------------------------ CP001
    def _check_class(
        self, pf: ParsedFile, cls: ast.ClassDef, findings: list[Finding]
    ) -> None:
        methods = [
            n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        by_name = {m.name: m for m in methods}
        commit = by_name.get("_commit_round")
        if commit is not None:
            protected: set[str] = set()
            for stmt in ast.walk(commit):
                for attr, _ in _self_attr_writes(stmt):
                    protected.add(attr)
            if protected:
                for m in methods:
                    if m.name in _EXEMPT_METHODS:
                        continue
                    for stmt in ast.walk(m):
                        for attr, site in _self_attr_writes(stmt):
                            if attr in protected:
                                findings.append(
                                    Finding(
                                        rule="CP001",
                                        path=pf.path,
                                        line=site.lineno,
                                        col=site.col_offset,
                                        message=(
                                            f"`self.{attr}` is round-committed "
                                            f"state (mutated by `_commit_round`) "
                                            f"but is also mutated in "
                                            f"`{cls.name}.{m.name}` — the "
                                            "two-site drift hazard"
                                        ),
                                        hint=(
                                            "funnel the update through "
                                            "_commit_round (accumulate into a "
                                            "_rb_* field reset by _round_reset)"
                                        ),
                                        symbol=f"{cls.name}.{m.name}",
                                    )
                                )
        self._check_pending(pf, cls, methods, findings)
        self._check_lifecycle(pf, cls, methods, findings)
        for m in methods:
            if isinstance(m, ast.AsyncFunctionDef):
                self._check_async(pf, cls, m, findings)

    # ------------------------------------------------------------ CP003
    def _check_pending(
        self,
        pf: ParsedFile,
        cls: ast.ClassDef,
        methods: list,
        findings: list[Finding],
    ) -> None:
        # the rule engages only on the pipelined-scheduler SHAPE: a class
        # with the reconcile funnel or a pipeline builder. A class that
        # happens to name an attribute `_pending_x` without that state
        # machine is left alone.
        if not any(
            m.name == "_apply_pending"
            or m.name.startswith(_PENDING_WRITER_PREFIX)
            for m in methods
        ):
            return
        for m in methods:
            if (
                m.name in _PENDING_WRITERS
                or m.name.startswith(_PENDING_WRITER_PREFIX)
            ):
                continue
            for attr, site in _pending_writes(m):
                findings.append(
                    Finding(
                        rule="CP003",
                        path=pf.path,
                        line=site.lineno,
                        col=site.col_offset,
                        message=(
                            f"`self.{attr}` is shadow/pending round state "
                            f"but is mutated in `{cls.name}.{m.name}` — "
                            "only the pipeline builders (`_pipeline_*`), "
                            "`_apply_pending`, `__init__`, and "
                            "`_round_reset` may write it (the speculate-"
                            "vs-commit drift hazard)"
                        ),
                        hint=(
                            "build the state in a `_pipeline_*` method and "
                            "consume it through `_apply_pending` (or a "
                            "`_pipeline_take_*` accessor), or rename the "
                            "attribute out of the `_pending` namespace if "
                            "it is not shadow state"
                        ),
                        symbol=f"{cls.name}.{m.name}",
                    )
                )

    # ------------------------------------------------------------ CP004
    def _check_lifecycle(
        self,
        pf: ParsedFile,
        cls: ast.ClassDef,
        methods: list,
        findings: list[Finding],
    ) -> None:
        # engages only on classes defining the transition funnel — a class
        # that happens to name an attribute `_replica_states` without the
        # state machine is left alone (the CP003 shape-gating pattern)
        if not any(m.name == _LIFECYCLE_FUNNEL for m in methods):
            return
        for m in methods:
            if m.name in _LIFECYCLE_WRITERS:
                continue
            sites: list[tuple[str, ast.AST]] = []
            for node in ast.walk(m):
                if isinstance(node, ast.stmt):
                    sites += [
                        (a, s)
                        for a, s in _self_attr_writes(node)
                        if a == _LIFECYCLE_ATTR
                    ]
                if isinstance(node, ast.Call):
                    f = node.func
                    if (
                        isinstance(f, ast.Attribute)
                        and f.attr in _MUTATING_CALLS
                        and isinstance(f.value, ast.Attribute)
                        and isinstance(f.value.value, ast.Name)
                        and f.value.value.id == "self"
                        and f.value.attr == _LIFECYCLE_ATTR
                    ):
                        sites.append((f.value.attr, node))
            for attr, site in sites:
                findings.append(
                    Finding(
                        rule="CP004",
                        path=pf.path,
                        line=site.lineno,
                        col=site.col_offset,
                        message=(
                            f"`self.{attr}` is replica lifecycle state but "
                            f"is mutated in `{cls.name}.{m.name}` — only "
                            f"`{_LIFECYCLE_FUNNEL}` and `__init__` may "
                            "write it (eligibility/metrics/flight fields "
                            "hang off the transition; a direct write ships "
                            "a half-applied one)"
                        ),
                        hint=(
                            f"route the transition through "
                            f"`{_LIFECYCLE_FUNNEL}` (it extends the list "
                            "for new arms itself)"
                        ),
                        symbol=f"{cls.name}.{m.name}",
                    )
                )

    # ------------------------------------------------------------ CP002
    def _check_async(
        self,
        pf: ParsedFile,
        cls: ast.ClassDef,
        fn: ast.AsyncFunctionDef,
        findings: list[Finding],
    ) -> None:
        # attr -> first await-epoch it was written in; flag the first write
        # in a LATER epoch (a write before and after some await)
        first_epoch: dict[str, int] = {}
        flagged: set[str] = set()
        epoch = 0

        def has_await(node: ast.AST) -> bool:
            return any(isinstance(n, ast.Await) for n in ast.walk(node))

        def locked(item: ast.withitem) -> bool:
            # async with self.<something lock-like>: the guarded block's
            # writes are safe — the lock IS the commit funnel. Only
            # name-plausible locks qualify; `async with self.session:`
            # (transports, transactions) provides no mutual exclusion and
            # its body is analyzed like any other statements.
            e = item.context_expr
            if isinstance(e, ast.Call):
                e = e.func
            return (
                isinstance(e, ast.Attribute)
                and isinstance(e.value, ast.Name)
                and e.value.id == "self"
                and re.search(r"lock|mutex|sem|cond", e.attr, re.IGNORECASE)
                is not None
            )

        def note_writes(stmt: ast.stmt) -> None:
            nonlocal epoch
            # the awaited RHS runs BEFORE the store: bump the epoch first
            # so `self.x = await f()` counts as a post-await write
            if has_await(stmt):
                epoch += 1
            if (
                isinstance(stmt, ast.Assign)
                and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is None
            ):
                return  # `self.x = None` is sentinel init, not a torn invariant
            for attr, site in _self_attr_writes(stmt):
                prev = first_epoch.setdefault(attr, epoch)
                if prev != epoch and attr not in flagged:
                    flagged.add(attr)
                    findings.append(
                        Finding(
                            rule="CP002",
                            path=pf.path,
                            line=site.lineno,
                            col=site.col_offset,
                            message=(
                                f"`self.{attr}` is written on both sides of "
                                f"an await in async "
                                f"`{cls.name}.{fn.name}` — another coroutine "
                                "can observe or interleave with the "
                                "half-updated state"
                            ),
                            hint=(
                                "hold an asyncio.Lock across the writes, or "
                                "funnel both into one commit point after "
                                "the await"
                            ),
                            symbol=f"{cls.name}.{fn.name}",
                        )
                    )

        def walk(body: list[ast.stmt]) -> None:
            nonlocal epoch
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, (ast.AsyncWith, ast.With)):
                    if isinstance(stmt, ast.AsyncWith):
                        epoch += 1  # acquiring awaits
                        if any(locked(i) for i in stmt.items):
                            if any(has_await(s) for s in stmt.body):
                                epoch += 1
                            continue  # guarded writes are safe
                    # non-lock context managers (sessions, transactions)
                    # provide no exclusion — analyze the body normally
                    walk(stmt.body)
                elif isinstance(stmt, ast.If):
                    # mutually exclusive branches do NOT see each other's
                    # awaits: walk each from the same starting epoch and
                    # join (max) afterward, else an await in the if-body
                    # falsely elevates the else-body's writes
                    if has_await(stmt.test):
                        epoch += 1
                    start = epoch
                    walk(stmt.body)
                    after_body = epoch
                    epoch = start
                    walk(stmt.orelse)
                    epoch = max(epoch, after_body)
                elif isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
                    if isinstance(stmt, ast.AsyncFor) or has_await(
                        stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor))
                        else stmt.test
                    ):
                        epoch += 1
                    walk(stmt.body)
                    walk(stmt.orelse)
                elif isinstance(stmt, ast.Try):
                    # an exception can fire BEFORE any of the body's
                    # awaits ran, so handlers walk from the body-START
                    # epoch (error-path recovery writes are not "after
                    # the await" on every execution); join (max) after
                    start = epoch
                    walk(stmt.body)
                    body_end = epoch
                    ends = [body_end]
                    for h in stmt.handlers:
                        epoch = start
                        walk(h.body)
                        ends.append(epoch)
                    epoch = body_end
                    walk(stmt.orelse)
                    ends.append(epoch)
                    epoch = max(ends)
                    walk(stmt.finalbody)
                else:
                    note_writes(stmt)
        walk(fn.body)
