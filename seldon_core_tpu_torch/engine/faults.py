"""Deterministic fault-injection harness for the data plane.

Port of ``seldon_core_tpu/engine/faults.py`` (the request path): a
``ChaosUnit`` wraps a node of a built executor and perturbs its calls on a
seeded schedule — latency, transport-class errors, hangs ("timeouts") and
flapping (windows of failure alternating with healthy windows) — so retry
paths, breaker transitions, deadline budgets and degradation are exercised
end to end on the real graph. Everything is driven by one seeded RNG
consumed in call order, so a (spec, seed) gives the same fault sequence on
every run. The decode tier's faults (``DecodeFaultSpec``,
``install_decode_faults``) arm one scheduler replica of a fleet: a round
that hangs, an induced allocator OOM, a readback stall, dropped health
probes, each a pure function of the call's ordinal.

    from seldon_core_tpu_torch.engine.faults import FaultSpec, install_faults
    install_faults(server.executor, {"iris-primary": FaultSpec(error_rate=1.0, seed=5)})
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import threading
from typing import Sequence

from seldon_core_tpu_torch import telemetry
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import Feedback, SeldonMessage
from seldon_core_tpu_torch.engine.units import Unit


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One node's fault profile. Rates are per-call probabilities drawn from
    the seeded RNG; ``flap_period`` > 0 switches to flapping mode where the
    FIRST ``flap_period`` calls of every 2x-period cycle fail at
    ``flap_error_rate`` and the rest at ``error_rate``."""

    error_rate: float = 0.0  # transport-class APIException
    latency_ms: float = 0.0  # added latency per call
    latency_jitter_ms: float = 0.0  # uniform extra latency on top
    timeout_rate: float = 0.0  # calls that hang for hang_s (deadline food)
    hang_s: float = 30.0
    flap_period: int = 0  # calls per unhealthy window; 0 = no flapping
    flap_error_rate: float = 1.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    action: str  # "ok" | "error" | "timeout"; decode rounds: "hang" | "oom"
    delay_s: float = 0.0


class FaultSchedule:
    """Seeded deterministic per-call decisions, in call order."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._rng = random.Random(spec.seed)
        self._lock = threading.Lock()
        self.calls = 0
        self.injected = 0

    def _error_rate_now(self) -> float:
        s = self.spec
        if s.flap_period <= 0:
            return s.error_rate
        phase = self.calls % (2 * s.flap_period)
        return s.flap_error_rate if phase < s.flap_period else s.error_rate

    def next(self) -> FaultDecision:
        with self._lock:
            s = self.spec
            rate = self._error_rate_now()
            self.calls += 1
            delay = s.latency_ms / 1000.0
            if s.latency_jitter_ms > 0:
                delay += self._rng.uniform(0, s.latency_jitter_ms / 1000.0)
            # one draw per decision point, always consumed, so the sequence
            # is a pure function of (spec, seed) regardless of outcomes
            err_draw = self._rng.random()
            timeout_draw = self._rng.random()
            if s.timeout_rate > 0 and timeout_draw < s.timeout_rate:
                self.injected += 1
                return FaultDecision("timeout", delay)
            if rate > 0 and err_draw < rate:
                self.injected += 1
                return FaultDecision("error", delay)
            return FaultDecision("ok", delay)


class ChaosUnit(Unit):
    """Wraps a runtime unit and perturbs its calls per a FaultSchedule.

    Installed per-node on a built executor (install_faults) — the wrapped
    unit keeps serving the non-faulted calls, so the graph under test is the
    REAL graph, not a stub. send_feedback passes through unperturbed:
    injecting faults into a non-idempotent method would make the harness
    itself corrupt learner state.
    """

    def __init__(self, inner: Unit, schedule: FaultSchedule, on_fault=None):
        super().__init__(inner.spec)
        self.inner = inner
        self.schedule = schedule
        self.image = inner.image
        self._on_fault = on_fault  # (unit_name, kind) -> None

    def ready(self) -> bool:
        return self.inner.ready()

    async def _perturb(self) -> None:
        d = self.schedule.next()
        if d.delay_s > 0:
            await asyncio.sleep(d.delay_s)
        if d.action != "ok":
            # an injected fault is an event of the request's trace
            telemetry.add_event("fault_injected", {"unit": self.name, "kind": d.action})
        if d.action == "timeout":
            if self._on_fault is not None:
                self._on_fault(self.name, "timeout")
            # hang well past any sane deadline; cancellable, so an expired
            # budget reclaims the subtree instead of waiting out the hang
            await asyncio.sleep(self.schedule.spec.hang_s)
            raise APIException(
                ErrorCode.ENGINE_MICROSERVICE_ERROR,
                f"chaos: injected timeout in '{self.name}'",
            )
        if d.action == "error":
            if self._on_fault is not None:
                self._on_fault(self.name, "error")
            raise APIException(
                ErrorCode.ENGINE_MICROSERVICE_ERROR,
                f"chaos: injected fault in '{self.name}'",
            )

    async def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        await self._perturb()
        return await self.inner.transform_input(msg)

    async def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        await self._perturb()
        return await self.inner.transform_output(msg)

    async def route(self, msg: SeldonMessage) -> int:
        await self._perturb()
        return await self.inner.route(msg)

    async def aggregate(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        await self._perturb()
        return await self.inner.aggregate(msgs)

    async def send_feedback(self, feedback: Feedback, routing: int) -> None:
        await self.inner.send_feedback(feedback, routing)


@dataclasses.dataclass(frozen=True)
class DecodeFaultSpec:
    """A decode-tier fault profile for one scheduler replica. Round ordinals
    are 1-based and count active decode rounds from ``install_decode_faults``
    on (``hang_at_round=1`` hits the very next round); probe ordinals count
    ``health_probe`` calls the same way. Every decision is a pure function
    of (spec, ordinal), so a rerun replays the same faults."""

    hang_at_round: int = 0  # the round that hangs (0: never)
    hang_s: float = 30.0  # how long it sleeps
    oom_at_round: int = 0  # the round whose page write hits an induced OOM
    readback_stall_ms: float = 0.0  # added stall per device readback
    stall_from_round: int = 0  # the first round the stall applies to (0: never)
    drop_health_from: int = 0  # the first probe dropped (0: never)
    drop_health_count: int = 0  # probes dropped from there (0: all)
    seed: int = 0


class DecodeFaultState:
    """The decode-tier fault schedule, which the scheduler consults at the top
    of each active round, at each readback and at each health probe; it
    counts those calls, so decisions depend on the spec and the ordinal
    alone, never on the clock."""

    def __init__(self, spec: DecodeFaultSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self.rounds = 0
        self.probes = 0
        self.injected = 0

    def round_decision(self) -> FaultDecision:
        with self._lock:
            self.rounds += 1
            s = self.spec
            if s.hang_at_round > 0 and self.rounds == s.hang_at_round:
                self.injected += 1
                return FaultDecision("hang", s.hang_s)
            if s.oom_at_round > 0 and self.rounds == s.oom_at_round:
                self.injected += 1
                return FaultDecision("oom")
            return FaultDecision("ok")

    def readback_stall_s(self) -> float:
        with self._lock:
            s = self.spec
            if s.readback_stall_ms > 0 and s.stall_from_round > 0 and self.rounds >= s.stall_from_round:
                self.injected += 1
                return s.readback_stall_ms / 1000.0
            return 0.0

    def health_drop(self) -> bool:
        with self._lock:
            self.probes += 1
            s = self.spec
            if s.drop_health_from <= 0 or self.probes < s.drop_health_from:
                return False
            if s.drop_health_count > 0 and self.probes >= s.drop_health_from + s.drop_health_count:
                return False
            self.injected += 1
            return True


def install_decode_faults(scheduler, spec: DecodeFaultSpec) -> DecodeFaultState:
    """Arm a DecodeScheduler (one fleet replica) with a decode fault profile,
    replacing any earlier one; returns the state, whose ``rounds``,
    ``probes`` and ``injected`` a chaos test reads."""
    state = DecodeFaultState(spec)
    scheduler._faults = state
    return state


def install_faults(
    executor, faults: dict[str, FaultSpec], on_fault=None
) -> dict[str, FaultSchedule]:
    """Wrap named nodes of a BUILT executor in ChaosUnits. Returns the live
    schedules keyed by node name (tests read .calls/.injected off them).
    Unknown node names are an error — a chaos test silently injecting into
    nothing would 'prove' resilience vacuously. ``on_fault`` defaults to
    the executor's resilience event sink."""
    if on_fault is None:
        on_fault = executor._events.fault_injected
    schedules: dict[str, FaultSchedule] = {}
    nodes = {n.name: n for n in executor.root.walk()}
    for name, spec in faults.items():
        node = nodes.get(name)
        if node is None:
            raise ValueError(
                f"install_faults: no node '{name}' in graph (have: {sorted(nodes)})"
            )
        schedule = FaultSchedule(spec)
        node.unit = ChaosUnit(node.unit, schedule, on_fault=on_fault)
        schedules[name] = schedule
    return schedules
