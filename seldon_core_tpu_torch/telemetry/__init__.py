"""End-to-end request tracing and decode-loop telemetry.

Port of ``seldon_core_tpu/telemetry/`` with its modules, names and
defaults; nothing here imports torch, so every layer can record through it.

The pieces:

- spans.py    — Span / TraceBuf model, monotonic epoch clock, ids
- context.py  — contextvar trace carrier, span()/add_event()/mark(),
                W3C traceparent propagation helpers
- store.py    — bounded ring store with tail-based sampling
- tracer.py   — request lifecycle + the process-global tracer
- export.py   — optional OTLP-JSON file export
- access_log.py — env-gated structured JSON access logs
- flight.py   — decode-loop flight recorder (per-round ring, host-phase +
                enqueue/readback attribution, goodput/SLO counters,
                /decode/flight + /decode/health registry)
- profile.py  — always-on low-rate decode-loop sampling profiler
                (bounded folded-stack table, GET /decode/profile)

Servers open an ingress root span per request (serving/service.py), which
continues an incoming W3C ``traceparent``; the executor, batcher and decode
scheduler record spans through the contextvar (or, across a thread hop, on
the contexts captured at submit), and the predictor's ingress reads the
store back out (GET /traces, GET /traces/{id}; serving/fast_http.py).
"""

from seldon_core_tpu_torch.telemetry.context import (
    TRACE,
    TraceContext,
    active,
    add_event,
    begin_spans,
    child_contexts,
    clear,
    end_spans,
    current_contexts,
    local_trace,
    local_traces,
    mark,
    parse_traceparent,
    span,
    traceparent,
)
from seldon_core_tpu_torch.telemetry.flight import FlightFrame, FlightRecorder
from seldon_core_tpu_torch.telemetry.spans import Span, TraceBuf, new_trace_id, now_ns
from seldon_core_tpu_torch.telemetry.store import SpanStore, TraceRecord
from seldon_core_tpu_torch.telemetry.tracer import (
    Tracer,
    configure,
    get_tracer,
    tracer_from_env,
)

__all__ = [
    "TRACE",
    "TraceContext",
    "FlightFrame",
    "FlightRecorder",
    "Span",
    "TraceBuf",
    "SpanStore",
    "TraceRecord",
    "Tracer",
    "active",
    "add_event",
    "begin_spans",
    "child_contexts",
    "end_spans",
    "clear",
    "configure",
    "current_contexts",
    "get_tracer",
    "local_trace",
    "local_traces",
    "mark",
    "new_trace_id",
    "now_ns",
    "parse_traceparent",
    "span",
    "traceparent",
    "tracer_from_env",
]
