"""Data-plane resilience primitives: deadline budgets, retries, breakers.

Port of ``seldon_core_tpu/engine/resilience.py``, the same objects and
rules:

- ``Deadline`` — a per-request budget stamped at the serving entrypoint and
  carried through the walk in the ``DEADLINE`` contextvar (tasks spawned
  during the walk inherit it; the micro-batcher re-stamps the LOOSEST of
  its batch-mates' budgets around the merged walk — each request's own
  budget is enforced at its ingress, so a tight mate cannot cancel the
  shared walk). Every node call checks the remaining budget.
- ``RetryState`` — per-node max attempts + jittered exponential backoff.
  The executor retries only idempotent methods (never send_feedback) on
  transport/5xx-class failures, and never sleeps past the deadline.
- ``CircuitBreaker`` — closed -> open (consecutive-failure or windowed
  error-rate threshold) -> half-open probe state machine, against an
  injectable clock. Open breakers fail fast with a 503 carrying
  Retry-After; routers with a configured fallback branch degrade around
  them instead of failing.
- ``ResilienceEvents`` — the sink every resilience action is reported to;
  ``NULL_EVENTS`` counts nothing (the port has no metrics registry yet).

All knobs ride the deployment CR as unit parameters — see
``graph/spec.py::ResilienceSpec`` for the names.
"""

from __future__ import annotations

import contextvars
import random
import time
from typing import Callable

from seldon_core_tpu_torch.core.errors import APIException, ErrorCode

# ------------------------------------------------------------------ deadline


class Deadline:
    """Absolute per-request budget against an injectable monotonic clock."""

    __slots__ = ("expires_at", "_clock")

    def __init__(self, budget_s: float, *, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.expires_at = clock() + budget_s

    def remaining(self) -> float:
        return self.expires_at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


# The carrier: set by the serving entrypoint (PredictionService) or the
# batcher's merged walk; read at every node-call boundary. A contextvar
# (not a threaded parameter): asyncio copies the context into every task it
# spawns, so the walk's concurrent branches inherit it.
DEADLINE: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "seldon_tpu_deadline", default=None
)


def current_deadline() -> Deadline | None:
    return DEADLINE.get()


def call_timeout(default_s: float) -> float:
    """Timeout for one remote call: the request's remaining budget when a
    deadline is stamped (replacing the fixed per-call default), else
    ``default_s``. Raises deadline-exceeded instead of dispatching a call
    whose budget is already gone."""
    d = DEADLINE.get()
    if d is None:
        return default_s
    remaining = d.remaining()
    if remaining <= 0.0:
        raise deadline_exceeded("remote call")
    return remaining


def deadline_exceeded(where: str) -> APIException:
    return APIException(
        ErrorCode.REQUEST_DEADLINE_EXCEEDED, f"budget exhausted at {where}"
    )


# -------------------------------------------------------------------- retry

# Methods safe to re-dispatch: inference-path calls are read-only over model
# state. send_feedback mutates learner state (bandit counts) and must never
# be replayed.
IDEMPOTENT_METHODS = frozenset(
    {"transform_input", "transform_output", "route", "aggregate", "predict"}
)

# Transport/5xx-class failures worth a retry. ENGINE_MICROSERVICE_ERROR is
# the code every normalised transport error (connect refused, reset, HTTP
# 5xx, gRPC UNAVAILABLE) surfaces as. Malformed-response and routing errors
# are deterministic — retrying replays the same failure.
RETRYABLE_CODES = frozenset({ErrorCode.ENGINE_MICROSERVICE_ERROR})


def is_retryable(exc: BaseException) -> bool:
    if isinstance(exc, APIException):
        return exc.error in RETRYABLE_CODES
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


class RetryState:
    """Runtime retry engine for one node (seeded RNG so backoff jitter — and
    therefore tests and fault-harness runs — is deterministic)."""

    def __init__(self, spec):
        self.max_attempts = max(int(spec.max_attempts), 1)
        self.backoff_s = float(spec.backoff_ms) / 1000.0
        self.backoff_mult = float(spec.backoff_mult)
        self.jitter = float(spec.jitter)
        self._rng = random.Random(spec.seed) if spec.seed is not None else random.Random()

    def backoff(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (1-based), jittered. Draws
        the RNG once — callers pass the SAME value to should_retry and to
        the sleep, so the duration validated against the deadline is the
        duration actually slept."""
        base = self.backoff_s * (self.backoff_mult ** (attempt - 1))
        if self.jitter > 0:
            base *= self._rng.uniform(max(0.0, 1.0 - self.jitter), 1.0 + self.jitter)
        return base

    def should_retry(
        self, method: str, attempt: int, exc: BaseException, backoff_s: float
    ) -> bool:
        """Retry iff the method is idempotent, attempts remain, the failure
        is transport/5xx-class, and ``backoff_s`` (the exact duration the
        caller will sleep) fits the remaining budget — never sleep past the
        deadline."""
        if attempt >= self.max_attempts:
            return False
        if method not in IDEMPOTENT_METHODS:
            return False
        if not is_retryable(exc):
            return False
        d = DEADLINE.get()
        if d is not None and d.remaining() <= backoff_s:
            return False
        return True


# ------------------------------------------------------------------ breaker

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def breaker_state_value(state: str) -> int:
    """Numeric encoding for the ``seldon_tpu_breaker_state`` gauge."""
    return _STATE_GAUGE[state]


class CircuitBreaker:
    """closed -> open -> half-open state machine for one endpoint.

    Opens on EITHER ``failure_threshold`` consecutive failures OR a windowed
    error rate >= ``error_rate`` once ``window`` outcomes have been seen.
    After ``reset_ms`` an open breaker admits ``half_open_probes`` probe
    calls; one success closes it, one failure re-opens it. The clock is
    injectable so the state machine is unit-testable without sleeping.
    """

    def __init__(
        self,
        spec,
        *,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[str], None] | None = None,
    ):
        self.failure_threshold = int(spec.failure_threshold)
        self.error_rate = float(spec.error_rate)
        self.window = max(int(spec.window), 1)
        self.reset_s = float(spec.reset_ms) / 1000.0
        self.half_open_probes = max(int(spec.half_open_probes), 1)
        self._clock = clock
        self._on_transition = on_transition
        self.state = CLOSED
        self._consecutive_failures = 0
        self._outcomes: list[bool] = []  # sliding window, True = failure
        self._opened_at = 0.0
        self._probes_in_flight = 0

    # ------------------------------------------------------------- internals
    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        if self._on_transition is not None:
            self._on_transition(state)

    def _maybe_half_open(self) -> None:
        if self.state == OPEN and self._clock() - self._opened_at >= self.reset_s:
            self._probes_in_flight = 0
            self._transition(HALF_OPEN)

    # ------------------------------------------------------------------ API
    def allow(self) -> bool:
        """Gate one call. Consumes a probe slot in half-open state."""
        self._maybe_half_open()
        if self.state == CLOSED:
            return True
        if self.state == HALF_OPEN:
            if self._probes_in_flight < self.half_open_probes:
                self._probes_in_flight += 1
                return True
            return False
        return False

    def is_open(self) -> bool:
        """Non-consuming peek (router fallback checks): True only while
        firmly open — a reset-elapsed breaker reads half-open so the probe
        traffic that would recover it is not diverted to the fallback."""
        self._maybe_half_open()
        return self.state == OPEN

    def release_probe(self) -> None:
        """Un-consume a half-open probe whose call produced NO verdict
        (cancelled, or the request's deadline fired) — without this the
        slot leaks and the breaker wedges in half-open with zero free
        probes, never able to recover."""
        if self.state == HALF_OPEN and self._probes_in_flight > 0:
            self._probes_in_flight -= 1

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self._push(False)
        if self.state == HALF_OPEN:
            self._outcomes.clear()
            self._transition(CLOSED)

    def record_failure(self) -> None:
        self._consecutive_failures += 1
        self._push(True)
        if self.state == HALF_OPEN:
            self._open()
            return
        if self.state != CLOSED:
            return
        if self._consecutive_failures >= self.failure_threshold:
            self._open()
            return
        if (
            len(self._outcomes) >= self.window
            and sum(self._outcomes) / len(self._outcomes) >= self.error_rate
        ):
            self._open()

    def _open(self) -> None:
        self._opened_at = self._clock()
        self._consecutive_failures = 0
        self._transition(OPEN)

    def _push(self, failed: bool) -> None:
        self._outcomes.append(failed)
        if len(self._outcomes) > self.window:
            del self._outcomes[0]

    def retry_after_s(self) -> float:
        """How long until the next probe could be admitted."""
        if self.state != OPEN:
            return 0.0
        return max(0.0, self.reset_s - (self._clock() - self._opened_at))


def breaker_open_error(endpoint: str, breaker: CircuitBreaker) -> APIException:
    e = APIException(
        ErrorCode.ENGINE_BREAKER_OPEN,
        f"circuit breaker open for '{endpoint}'",
        retry_after_s=breaker.retry_after_s(),
    )
    return e


def is_breaker_open_error(exc: BaseException) -> bool:
    return isinstance(exc, APIException) and exc.error is ErrorCode.ENGINE_BREAKER_OPEN


# -------------------------------------------------------------- event sinks


class ResilienceEvents:
    """No-op event sink. The executor reports every resilience action here;
    the server hands it ``metrics.registry.MetricsResilienceEvents``, which
    forwards each to the metrics registry, and tests substitute recorders."""

    def retry(self, unit: str, attempt: int) -> None:
        pass

    def breaker_transition(self, endpoint: str, state: str) -> None:
        pass

    def deadline_exceeded(self, unit: str) -> None:
        pass

    def degraded(self, unit: str, mode: str) -> None:
        pass

    def fault_injected(self, unit: str, kind: str) -> None:
        pass


NULL_EVENTS = ResilienceEvents()
