"""Optional OTLP-JSON file export: one JSON line per RETAINED trace.

Port of ``seldon_core_tpu/telemetry/export.py``, unchanged.

The line is an OTLP/HTTP JSON ``ExportTraceServiceRequest`` body (the shape
``otel-collector``'s file receiver and most trace tooling ingest), so a
chaos or load run's retained traces can be dragged into any OTel-speaking
viewer without this process hosting an exporter pipeline. Gated by
``ENGINE_OTLP_FILE=<path>`` (utils/env.py); export failures log and never
touch the serving path.
"""

from __future__ import annotations

import json
import logging
import threading

log = logging.getLogger(__name__)


def _attr_list(attrs: dict | None) -> list[dict]:
    out = []
    for k, v in (attrs or {}).items():
        if isinstance(v, bool):
            value = {"boolValue": v}
        elif isinstance(v, int):
            value = {"intValue": str(v)}
        elif isinstance(v, float):
            value = {"doubleValue": v}
        else:
            value = {"stringValue": str(v)}
        out.append({"key": str(k), "value": value})
    return out


def trace_to_otlp(record) -> dict:
    """One TraceRecord as an OTLP ExportTraceServiceRequest dict."""
    spans = []
    for s in sorted(record.spans, key=lambda s: s.start_ns):
        span: dict = {
            "traceId": s.trace_id,
            "spanId": s.span_id,
            "name": s.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(s.start_ns),
            "endTimeUnixNano": str(s.end_ns or s.start_ns),
            "attributes": _attr_list(s.attrs),
            "status": {"code": 2 if s.error else 1},
        }
        if s.parent_id:
            span["parentSpanId"] = s.parent_id
        if s.events:
            span["events"] = [
                {
                    "timeUnixNano": str(e.ts_ns),
                    "name": e.name,
                    "attributes": _attr_list(e.attrs),
                }
                for e in s.events
            ]
        spans.append(span)
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": _attr_list(
                        {"service.name": "seldon-core-tpu", "seldon.puid": record.puid}
                    )
                },
                "scopeSpans": [
                    {"scope": {"name": "seldon_core_tpu_torch.telemetry"}, "spans": spans}
                ],
            }
        ]
    }


class OtlpFileExporter:
    """Append-only JSON-lines writer, serialized under a lock (the serving
    loop and reconciler threads may both complete traces)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def export(self, record) -> None:
        try:
            line = json.dumps(trace_to_otlp(record), separators=(",", ":"))
            with self._lock, open(self.path, "a") as f:
                f.write(line + "\n")
        except Exception:  # noqa: BLE001 - export must never fail a request
            log.exception("OTLP file export failed (path=%s)", self.path)
