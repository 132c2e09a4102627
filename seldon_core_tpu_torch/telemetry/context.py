"""Contextvar-carried trace context + W3C traceparent propagation.

Port of ``seldon_core_tpu/telemetry/context.py``, unchanged.

The context is a TUPLE of (buf, current-span) pairs, not a single pair:
the micro-batcher runs ONE merged walk for many coalesced requests, and
every span recorded during that walk belongs to EVERY batch-mate's trace.
The scalar path carries a 1-tuple; asyncio copies the contextvar into every
task spawned during the walk, so detached helpers inherit it for free
(exactly like the deadline budget in engine/resilience.py).

Propagation uses the W3C Trace Context header shape:

    traceparent: 00-<32 hex trace id>-<16 hex parent span id>-01

sent on remote REST calls as an HTTP header and on gRPC calls as metadata;
the serving side extracts it and CONTINUES the trace, so a multi-pod graph
walk stitches into one tree (the store merges fragments by trace id).
"""

from __future__ import annotations

import contextvars
import re
from contextlib import contextmanager
from typing import Any, Iterator, Sequence

from seldon_core_tpu_torch.telemetry.spans import Span, TraceBuf, new_trace_id, now_ns


class TraceContext:
    """One trace's view of the current position in the walk."""

    __slots__ = ("buf", "span")

    def __init__(self, buf: TraceBuf, span: Span):
        self.buf = buf
        self.span = span


TRACE: contextvars.ContextVar[tuple[TraceContext, ...]] = contextvars.ContextVar(
    "seldon_tpu_trace", default=()
)


def active() -> bool:
    return bool(TRACE.get())


def current_contexts() -> tuple[TraceContext, ...]:
    return TRACE.get()


def clear() -> None:
    """Detach the current task from any trace (shadow mirror walks: their
    spans must not land in a request trace that has already shipped)."""
    TRACE.set(())


@contextmanager
def span(name: str, attrs: dict | None = None) -> Iterator[Span | None]:
    """Record one span per active trace around the body. Within the body the
    new span(s) are the current parent — nested spans and propagated remote
    hops link under them. An escaping exception marks the span(s) errored."""
    ctxs = TRACE.get()
    if not ctxs:
        yield None
        return
    spans = tuple(c.buf.begin(name, c.span.span_id, attrs) for c in ctxs)
    token = TRACE.set(tuple(TraceContext(c.buf, s) for c, s in zip(ctxs, spans)))
    try:
        yield spans[0]
    except BaseException:
        for s in spans:
            s.error = True
        raise
    finally:
        TRACE.reset(token)
        t = now_ns()
        for s in spans:
            s.end(t)


def begin_spans(name: str, attrs: dict | None = None):
    """Imperative twin of span() for per-unit-call hot paths (skips the
    contextmanager generator machinery): returns an opaque handle for
    end_spans, or None when no trace is active."""
    ctxs = TRACE.get()
    if not ctxs:
        return None
    spans = tuple(c.buf.begin(name, c.span.span_id, attrs) for c in ctxs)
    token = TRACE.set(tuple(TraceContext(c.buf, s) for c, s in zip(ctxs, spans)))
    return spans, token


def end_spans(handle, error: bool = False) -> None:
    if handle is None:
        return
    spans, token = handle
    TRACE.reset(token)
    t = now_ns()
    for s in spans:
        if error:
            s.error = True
        s.end(t)


def add_event(name: str, attrs: dict | None = None) -> None:
    """Attach an event to the current span of every active trace (resilience
    actions: retries, breaker transitions, faults, degradation)."""
    for c in TRACE.get():
        c.span.add_event(name, attrs)


def mark(flag: str) -> None:
    """Set a tail-sampling keep flag on every active trace buf."""
    for c in TRACE.get():
        c.buf.flags.add(flag)


def child_contexts(
    ctxs: Sequence[TraceContext],
    name: str,
    attrs: dict | None = None,
    start_ns: int | None = None,
) -> tuple[tuple[TraceContext, ...], list[Span]]:
    """Open one child span per given context and return the shifted contexts
    plus the open spans (caller ends them). The micro-batcher uses this to
    run a merged walk under EVERY batch-mate's trace at once, each mate's
    walk spans parented to its own batcher span."""
    out_ctx: list[TraceContext] = []
    spans: list[Span] = []
    for c in ctxs:
        s = c.buf.begin(name, c.span.span_id, attrs, start_ns)
        spans.append(s)
        out_ctx.append(TraceContext(c.buf, s))
    return tuple(out_ctx), spans


# ------------------------------------------------------------- propagation

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def traceparent() -> str | None:
    """The propagation header for an outgoing remote hop, or None when no
    trace is active. Under a batched (multi-context) walk the FIRST mate's
    trace carries the hop — the server-side continuation lands in that
    mate's tree (batch-mates share the walk timings either way)."""
    ctxs = TRACE.get()
    if not ctxs:
        return None
    c = ctxs[0]
    return f"00-{c.buf.trace_id}-{c.span.span_id}-01"


def parse_traceparent(header: Any) -> tuple[str, str] | None:
    """(trace_id, parent_span_id) from an incoming traceparent header, or
    None when absent/malformed (a bad header must never fail a request —
    the trace just starts fresh)."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, parent_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id, parent_id


# ------------------------------------------------------------ local traces


@contextmanager
def local_trace(puid: str = "") -> Iterator[TraceBuf]:
    """A store-less trace for direct executor use (a request tagged
    {"trace": ...} executed without a serving ingress still gets spans
    back). The buf is complete when the context exits."""
    buf = TraceBuf(new_trace_id(), puid=puid)
    root = buf.begin("request")
    token = TRACE.set((TraceContext(buf, root),))
    try:
        yield buf
    finally:
        TRACE.reset(token)
        root.end()


@contextmanager
def local_traces(puids: Sequence[str]) -> Iterator[list[TraceBuf]]:
    """Store-less traces for a direct BATCHED executor call: one buf per
    request, all active at once, so the merged walk's spans land in every
    request's trace (the batched twin of local_trace)."""
    bufs = [TraceBuf(new_trace_id(), puid=p) for p in puids]
    roots = [b.begin("request") for b in bufs]
    token = TRACE.set(tuple(TraceContext(b, r) for b, r in zip(bufs, roots)))
    try:
        yield bufs
    finally:
        TRACE.reset(token)
        t = now_ns()
        for r in roots:
            r.end(t)
