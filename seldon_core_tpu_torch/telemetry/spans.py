"""Span model: the per-request unit of the tracing subsystem.

Port of ``seldon_core_tpu/telemetry/spans.py``, unchanged.

A request produces ONE trace (identified by a 16-byte hex trace id, linked
to the request puid) made of spans: ingress, batcher queue, per-unit method
calls, remote hops, decode-scheduler work. Spans carry attributes (the same
labels the prometheus metrics use, so a trace and a dashboard panel describe
each other) and events (what the resilience layer DID to the request —
retries, breaker transitions, fault injections, degradation).

Timestamps come from ``now_ns()``: a perf_counter-based clock anchored to
the epoch at import, so timestamps are strictly monotonic within a process
(``time.time_ns`` can step backwards under NTP) while remaining comparable
across processes to wall-clock accuracy — good enough to stitch a
multi-pod graph walk into one tree.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Any

_WALL0 = time.time_ns()
_PERF0 = time.perf_counter_ns()

# ids come from a urandom-SEEDED PRNG, not os.urandom per id: trace/span ids
# need uniqueness, not cryptographic strength, and a getrandom syscall per
# span (~50 us under some virtualized kernels) would dominate the whole
# tracing overhead budget. getrandbits is a single C call under the GIL.
_ID_RNG = random.Random(int.from_bytes(os.urandom(16), "big"))

# spans cap their event list so a pathological request (a breaker flapping
# thousands of times inside one retry loop) cannot grow a span without bound;
# the drop count is recorded so the truncation is visible, not silent
MAX_EVENTS_PER_SPAN = 128


def now_ns() -> int:
    """Monotonic epoch-anchored nanoseconds (see module docstring)."""
    return _WALL0 + time.perf_counter_ns() - _PERF0


def new_trace_id() -> str:
    return f"{_ID_RNG.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_ID_RNG.getrandbits(64):016x}"


@dataclasses.dataclass
class SpanEvent:
    name: str
    ts_ns: int
    attrs: dict[str, Any] | None = None

    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "ts_ns": self.ts_ns}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Span:
    """One timed operation within a trace."""

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "start_ns",
        "end_ns",
        "attrs",
        "events",
        "error",
        "dropped_events",
    )

    def __init__(
        self,
        trace_id: str,
        name: str,
        parent_id: str = "",
        attrs: dict | None = None,
        start_ns: int | None = None,
    ):
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.start_ns = start_ns if start_ns is not None else now_ns()
        self.end_ns = 0
        self.attrs = attrs
        self.events: list[SpanEvent] | None = None
        self.error = False
        self.dropped_events = 0

    def end(self, ts_ns: int | None = None) -> None:
        if self.end_ns == 0:
            self.end_ns = ts_ns if ts_ns is not None else now_ns()

    def add_event(self, name: str, attrs: dict | None = None) -> None:
        if self.events is None:
            self.events = []
        if len(self.events) >= MAX_EVENTS_PER_SPAN:
            self.dropped_events += 1
            return
        self.events.append(SpanEvent(name, now_ns(), attrs))

    @property
    def duration_ms(self) -> float:
        end = self.end_ns or self.start_ns
        return (end - self.start_ns) / 1e6

    def to_dict(self) -> dict:
        d: dict = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns or self.start_ns,
            "ms": round(self.duration_ms, 3),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = [e.to_dict() for e in self.events]
        if self.error:
            d["error"] = True
        if self.dropped_events:
            d["dropped_events"] = self.dropped_events
        return d


class TraceBuf:
    """In-flight span collection for ONE request in this process.

    The contextvar carries (buf, current-span) pairs through the walk; every
    span recorded lands here. When the request's root span ends, the buf is
    offered to the SpanStore, which applies tail sampling. ``flags`` drive
    the always-keep policy: "error", "deadline", "degraded", "forced"
    (request explicitly tagged for tracing)."""

    __slots__ = ("trace_id", "puid", "spans", "flags")

    def __init__(self, trace_id: str, puid: str = ""):
        self.trace_id = trace_id
        self.puid = puid
        self.spans: list[Span] = []
        self.flags: set[str] = set()

    def begin(
        self,
        name: str,
        parent_id: str = "",
        attrs: dict | None = None,
        start_ns: int | None = None,
    ) -> Span:
        span = Span(self.trace_id, name, parent_id, attrs, start_ns)
        self.spans.append(span)
        return span

    def event_count(self, name: str) -> int:
        """How many events of ``name`` were recorded anywhere in this trace
        (the access log reads retry counts through this)."""
        n = 0
        for s in self.spans:
            if s.events:
                n += sum(1 for e in s.events if e.name == name)
        return n

    def tag_spans(self) -> list[dict]:
        """The client-visible ``tags["trace"]`` list: unit-method spans in
        the legacy {"unit", "method", "ms"} shape (superset: span ids ride
        along so a client can cross-reference GET /traces/{id})."""
        out = []
        for s in self.spans:
            a = s.attrs or {}
            if "unit" not in a or "method" not in a:
                continue
            out.append(
                {
                    "unit": a["unit"],
                    "method": a["method"],
                    "ms": round(s.duration_ms, 3),
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                }
            )
        return out
