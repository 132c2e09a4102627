"""Transport-neutral engine handlers (port of
``seldon_core_tpu/serving/wire.py``: ``engine_predictions``,
``engine_predictions_stream``, ``engine_feedback``, ``sse_frame``,
``classify_binary_bytes`` and ``npy_wire_response``), plus the telemetry
read-outs: ``/metrics`` with the JAX REST app's format negotiation
(``seldon_core_tpu/serving/http_util.py::prometheus_response``) and the
trace, flight and profile routes of the JAX operator API
(``seldon_core_tpu/operator/api.py``), with its query-validation contract.

Every failure leaves as the reference's status-JSON body with the error
code's HTTP status, never as an HTML 500, and is counted in
``seldon_api_ingress_server_errors``. A request's W3C ``traceparent``
header reaches the service, whose trace continues it.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from urllib.parse import parse_qs

from seldon_core_tpu_torch.core.codec_json import (
    feedback_from_dict,
    message_from_json,
    message_to_json,
    meta_to_dict,
)
from seldon_core_tpu_torch.core.codec_npy import is_npy
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import SeldonMessage

log = logging.getLogger(__name__)

NPY_CONTENT_TYPES = ("application/x-npy", "application/octet-stream")
# a Seldon-Meta header longer than this is cut to puid and routing
META_HEADER_MAX = 6144


@dataclass
class WireRequest:
    """What a transport reduces a request to: method, path, LOWERCASE
    header dict, raw body bytes, and the query string (after ``?``)."""

    method: str
    path: str
    headers: dict[str, str]
    body: bytes
    query: str = ""

    def query_param(self, key: str) -> str | None:
        """The first value of ``key`` in the query string, or None."""
        values = parse_qs(self.query, keep_blank_values=True).get(key)
        return values[0] if values else None

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";", 1)[0].strip().lower()


@dataclass
class WireResponse:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def text(text: str, status: int = 200) -> "WireResponse":
        return WireResponse(status=status, body=text.encode(), content_type="text/plain")

    @staticmethod
    def json(obj, status: int = 200) -> "WireResponse":
        return WireResponse(status=status, body=json.dumps(obj).encode())


@dataclass
class WireStreamResponse:
    """A streaming response: ``events`` is an async iterator of bytes
    chunks (SSE frames), which the transport writes as they come under
    Transfer-Encoding: chunked."""

    events: object  # AsyncIterator[bytes]
    status: int = 200
    content_type: str = "text/event-stream"
    headers: dict[str, str] = field(default_factory=dict)


def sse_frame(obj) -> bytes:
    """One server-sent-events data frame."""
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"


def failure_response(e: BaseException, op: str, service=None) -> WireResponse:
    """The status-JSON failure, counted in the service's error counter; an
    open breaker's 503 carries Retry-After, so clients back off until its
    next probe could be admitted."""
    if not isinstance(e, APIException):
        log.exception("unhandled error serving %s", op)
        e = APIException(ErrorCode.ENGINE_MICROSERVICE_ERROR, str(e))
    if service is not None:
        service.metrics.ingress_error(service.deployment_name, op, e.error.code)
    retry_after = e.retry_after_header()
    return WireResponse(
        status=e.error.http_status,
        body=json.dumps(e.to_status_json()).encode(),
        headers={} if retry_after is None else {"Retry-After": retry_after},
    )


def classify_binary_bytes(ctype: str, raw: bytes) -> str:
    """``"npy"``, ``"bin"`` or ``"json"``: application/x-npy is npy;
    application/octet-stream is npy when the bytes start with the npy
    magic, else opaque binData; any other content type is JSON."""
    if ctype not in NPY_CONTENT_TYPES:
        return "json"
    if ctype == "application/x-npy" or is_npy(raw):
        return "npy"
    return "bin"


def npy_wire_response(out: SeldonMessage) -> WireResponse:
    """Raw npy body, meta in the ``Seldon-Meta`` header; a meta longer than
    META_HEADER_MAX is cut to puid and routing with ``truncated``."""
    meta_json = json.dumps(meta_to_dict(out.meta))
    if len(meta_json) > META_HEADER_MAX:
        meta_json = json.dumps(
            {"puid": out.meta.puid, "routing": dict(out.meta.routing), "truncated": True}
        )
    return WireResponse(body=out.bin_data, content_type="application/x-npy", headers={"Seldon-Meta": meta_json})


async def engine_predictions(service, req: WireRequest) -> WireResponse:
    """POST /api/v0.1/predictions against one PredictionService: a JSON
    SeldonMessage, or a raw npy body answered in npy."""
    try:
        kind = classify_binary_bytes(req.content_type, req.body)
        tp = req.headers.get("traceparent")
        if kind != "json":
            out = await service.predict(SeldonMessage(bin_data=req.body), wire_npy=kind == "npy", traceparent=tp)
            if kind == "npy" and is_npy(out.bin_data):
                return npy_wire_response(out)
            return WireResponse(body=message_to_json(out).encode())
        out = await service.predict(message_from_json(req.body), traceparent=tp)
        return WireResponse(body=message_to_json(out).encode())
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, "predict", service)


async def engine_feedback(service, req: WireRequest) -> WireResponse:
    """POST /api/v0.1/feedback: a JSON Feedback whose response meta carries
    the routing to reward."""
    try:
        try:
            obj = json.loads(req.body)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise APIException(ErrorCode.ENGINE_INVALID_JSON, str(e)) from e
        out = await service.send_feedback(feedback_from_dict(obj), traceparent=req.headers.get("traceparent"))
        return WireResponse(body=message_to_json(out).encode())
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, "feedback", service)


async def engine_predictions_stream(service, req: WireRequest):
    """POST /api/v0.1/predictions/stream: per-token SSE for the generative
    tier (``PredictionService.predict_stream``). Events: ``data: {"row": r,
    "index": i, "token": t}`` per generated token, then ``data: {"done":
    true, "ids": [[...]], ...}``. The request is parsed as /predictions
    parses it; per-request sampling rides meta.tags.

    The first event is awaited before the head is committed, so a request
    that fails validation gets an ordinary status-JSON failure; a failure
    after streaming began is sent as a terminal error event."""
    try:
        kind = classify_binary_bytes(req.content_type, req.body)
        msg = SeldonMessage(bin_data=req.body) if kind != "json" else message_from_json(req.body)
        gen = service.predict_stream(msg, wire_npy=kind == "npy", traceparent=req.headers.get("traceparent"))
        first = await gen.__anext__()
    except StopAsyncIteration:
        return WireResponse(status=500, body=b'{"status":"FAILURE"}')
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, "predict_stream", service)

    async def events():
        try:
            yield sse_frame(first)
            try:
                async for ev in gen:
                    yield sse_frame(ev)
            except Exception as e:  # noqa: BLE001 - the head is already committed
                log.exception("stream failed mid-flight")
                err = e.to_status_json() if isinstance(e, APIException) else {"status": "FAILURE"}
                yield sse_frame({"error": err})
        finally:
            # a client that disconnects must reach the service generator,
            # whose finally cancels the generation
            await gen.aclose()

    return WireStreamResponse(events=events())


# ------------------------------------------------------------ telemetry read-out

OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text"


def metrics_response(metrics, req: WireRequest) -> WireResponse:
    """GET /metrics: ``?format=openmetrics`` or an OpenMetrics ``Accept``
    header selects the exposition that carries the trace exemplars."""
    if metrics is None:
        return WireResponse(body=b"", content_type="text/plain")
    if req.query_param("format") == "openmetrics" or OPENMETRICS_CONTENT_TYPE in req.headers.get("accept", ""):
        return WireResponse(body=metrics.export_openmetrics(), content_type=OPENMETRICS_CONTENT_TYPE)
    return WireResponse(body=metrics.export(), content_type="text/plain")


def _query_int(req: WireRequest, key: str) -> tuple[int | None, WireResponse | None]:
    """(value, error): value None when absent; a present value that is not
    a positive integer is a 400 with {"error", "param", "got"}, never a
    silent default — a dashboard polling with a typo must see its bug."""
    raw = req.query_param(key)
    if raw is None:
        return None, None
    try:
        value = int(raw)
    except (TypeError, ValueError):
        value = 0
    if value < 1:
        return None, WireResponse.json(
            {"error": f"?{key} must be a positive integer", "param": key, "got": raw}, status=400
        )
    return value, None


def traces_list(req: WireRequest) -> WireResponse:
    """GET /traces: retained trace summaries (?sort=slow|recent, ?n=) and
    the store's sampler counters."""
    from seldon_core_tpu_torch.telemetry import get_tracer

    store = get_tracer().store
    try:
        n = int(req.query_param("n") or "50")
    except ValueError:
        n = 50
    sort = req.query_param("sort") or "recent"
    return WireResponse.json({"stats": store.stats(), "traces": [r.summary() for r in store.list(sort=sort, n=n)]})


def trace_get(req: WireRequest) -> WireResponse:
    """GET /traces/{id}: one span tree, by trace id or by request puid."""
    from seldon_core_tpu_torch.telemetry import get_tracer

    rec = get_tracer().store.get(req.path.rsplit("/", 1)[-1])
    if rec is None:
        return WireResponse.json({"error": "trace not found (by trace_id or puid)"}, status=404)
    return WireResponse.json(rec.to_dict())


def decode_flight(req: WireRequest) -> WireResponse:
    """GET /decode/flight: recent frames (?n=, default 64) and windowed
    aggregates (?window=, default the whole ring) per recorder (?name=)."""
    from seldon_core_tpu_torch.telemetry import flight

    n, err = _query_int(req, "n")
    if err is None:
        window, err = _query_int(req, "window")
    if err is not None:
        return err
    return WireResponse.json(
        flight.flight_report(n=n if n is not None else 64, name=req.query_param("name"),
                             window=window if window is not None else 0)
    )


def decode_health(req: WireRequest) -> WireResponse:
    """GET /decode/health: the O(1) per-recorder health summaries."""
    from seldon_core_tpu_torch.telemetry import flight

    return WireResponse.json(flight.health_report())


def decode_profile(req: WireRequest) -> WireResponse:
    """GET /decode/profile: the sampling profiler's top self-time frames
    (?n=, default 30) and folded table; ?hz= retunes the rate for the
    process, capped at 200 so a cached link cannot turn the always-on
    sampler hot."""
    from seldon_core_tpu_torch.telemetry import profile

    n, err = _query_int(req, "n")
    if err is None:
        hz, err = _query_int(req, "hz")
    if err is not None:
        return err
    prof = profile.get_profiler()
    if hz is not None:
        effective = prof.set_hz(min(hz, 200))
        log.info("decode profiler retuned to %s Hz via GET /decode/profile", effective)
    return WireResponse.json(prof.report(n=n if n is not None else 30))
