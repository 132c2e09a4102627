"""Transport-neutral engine handlers (port of
``seldon_core_tpu/serving/wire.py``: ``engine_predictions``,
``engine_predictions_stream``, ``engine_feedback``, ``sse_frame``,
``classify_binary_bytes``, ``npy_wire_response``, and the reference's
``json=`` form field of urlencoded and multipart bodies through
``payload_obj`` and ``_multipart_field``), plus the telemetry
read-outs: ``/metrics`` with the JAX REST app's format negotiation
(``seldon_core_tpu/serving/http_util.py::prometheus_response``) and the
trace, flight and profile routes of the JAX operator API
(``seldon_core_tpu/operator/api.py``), with its query-validation contract.

The reference's internal microservice API (``engine_unit_method``,
``INTERNAL_API_METHODS``: what a remote engine's ``RemoteUnit`` calls) and
the OAuth gateway's handlers (``gateway_predictions``,
``gateway_feedback``, ``gateway_token``, and gRPC-Web's
``gateway_grpc_web_predict`` and ``gateway_grpc_web_feedback`` on
``GRPC_WEB_ROUTES``) are here too, shared by every route table of
``serving/fast_http.py``.

Every failure leaves as the reference's status-JSON body with the error
code's HTTP status, never as an HTML 500, and is counted in
``seldon_api_ingress_server_errors``. A request's W3C ``traceparent``
header reaches the service, whose trace continues it. JSON bodies decode
through ``message_from_json_fast`` and answers encode through
``message_to_json_fast`` where the JAX package's handlers call them (the
native codec on large number matrices).
"""

from __future__ import annotations

import base64
import json
import logging
import re
import time
from dataclasses import dataclass, field
from urllib.parse import parse_qs

import numpy as np

from seldon_core_tpu_torch.core.codec_json import (
    feedback_from_dict,
    message_from_dict,
    message_from_json_fast,
    message_to_json_fast,
    meta_to_dict,
)
from seldon_core_tpu_torch.core.codec_npy import is_npy
from seldon_core_tpu_torch.core.errors import APIException, ErrorCode
from seldon_core_tpu_torch.core.message import SeldonMessage

log = logging.getLogger(__name__)

NPY_CONTENT_TYPES = ("application/x-npy", "application/octet-stream")
# bodies that carry the request in a ``json=`` form field (the reference's
# wire quirk, wrappers/python/microservice.py)
FORM_CONTENT_TYPES = ("application/x-www-form-urlencoded", "multipart/form-data")
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


def failure_response(
    e: BaseException,
    op: str,
    service=None,
    *,
    fallback_code: ErrorCode = ErrorCode.ENGINE_MICROSERVICE_ERROR,
    metrics_error=None,
) -> WireResponse:
    """The status-JSON failure (an error that is not an APIException
    becomes ``fallback_code``), counted in the service's error counter or
    through ``metrics_error(code)``; an open breaker's 503 carries
    Retry-After, so clients back off until its next probe could be
    admitted."""
    if not isinstance(e, APIException):
        log.exception("unhandled error serving %s", op)
        e = APIException(fallback_code, str(e))
    if service is not None:
        service.metrics.ingress_error(service.deployment_name, op, e.error.code)
    if metrics_error is not None:
        metrics_error(e.error.code)
    retry_after = e.retry_after_header()
    return WireResponse(
        status=e.error.http_status,
        body=json.dumps(e.to_status_json()).encode(),
        headers={} if retry_after is None else {"Retry-After": retry_after},
    )


def classify_binary_bytes(ctype: str, raw: bytes, sniff_npy: bool = True) -> str:
    """``"npy"``, ``"bin"`` or ``"json"``: application/x-npy is npy (an
    explicit opt-in, honoured whatever ``sniff_npy`` says);
    application/octet-stream is npy when ``sniff_npy`` is on
    (``tpu.decode_npy_bindata``) and the bytes start with the npy magic,
    else opaque binData; any other content type is JSON."""
    if ctype not in NPY_CONTENT_TYPES:
        return "json"
    if ctype == "application/x-npy" or (sniff_npy and is_npy(raw)):
        return "npy"
    return "bin"


def _multipart_field(req: WireRequest, field_name: str) -> str | None:
    """One text field of a multipart/form-data body, or None."""
    m = re.search(r'boundary="?([^";]+)"?', req.headers.get("content-type", ""))
    if not m:
        return None
    delim = b"--" + m.group(1).encode()
    needle = f'name="{field_name}"'.encode()
    for part in req.body.split(delim):
        head, sep, payload = part.partition(b"\r\n\r\n")
        if sep and needle in head:
            return payload.rstrip(b"\r\n").decode("utf-8", errors="replace")
    return None


def payload_obj(req: WireRequest, invalid_code: ErrorCode) -> dict:
    """The request's JSON object: the body, or the ``json=`` field of an
    urlencoded or multipart form. A form without the field, and a body or
    field that is not JSON, raise ``invalid_code``."""
    ctype = req.content_type
    if ctype in FORM_CONTENT_TYPES:
        if ctype.startswith("multipart"):
            raw = _multipart_field(req, "json")
        else:
            raw = (parse_qs(req.body.decode("utf-8", errors="replace")).get("json") or [None])[0]
        if raw is None:
            raise APIException(invalid_code, "missing 'json' form field")
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise APIException(invalid_code, str(e)) from e
    try:
        return json.loads(req.body)
    except Exception as e:  # noqa: BLE001 - any undecodable body is the same 400
        raise APIException(invalid_code, str(e)) from e


def _message(req: WireRequest) -> SeldonMessage:
    """A JSON request's SeldonMessage: a form's ``json=`` field, else the
    body."""
    if req.content_type in FORM_CONTENT_TYPES:
        return message_from_dict(payload_obj(req, ErrorCode.ENGINE_INVALID_JSON))
    return message_from_json_fast(req.body)


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
        kind = classify_binary_bytes(req.content_type, req.body, service.decode_npy)
        tp = req.headers.get("traceparent")
        if kind != "json":
            out = await service.predict(SeldonMessage(bin_data=req.body), wire_npy=kind == "npy", traceparent=tp)
            if kind == "npy" and is_npy(out.bin_data):
                return npy_wire_response(out)
            return WireResponse(body=message_to_json_fast(out))
        out = await service.predict(_message(req), traceparent=tp)
        return WireResponse(body=message_to_json_fast(out))
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, "predict", service)


async def engine_feedback(service, req: WireRequest) -> WireResponse:
    """POST /api/v0.1/feedback: a JSON Feedback (the body or a form's
    ``json=`` field) whose response meta carries the routing to reward."""
    try:
        obj = payload_obj(req, ErrorCode.ENGINE_INVALID_JSON)
        out = await service.send_feedback(feedback_from_dict(obj), traceparent=req.headers.get("traceparent"))
        return WireResponse(body=message_to_json_fast(out))
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, "feedback", service)


# ------------------------------------------------- internal microservice API

INTERNAL_API_METHODS = ("predict", "route", "send-feedback", "transform-input", "transform-output", "aggregate")


async def engine_unit_method(service, req: WireRequest, method: str) -> WireResponse:
    """The reference's internal microservice API (internal-api.md; the
    routes of wrappers/python/microservice.py) on a served graph: what an
    engine's ``RemoteUnit`` calls. ``/predict`` is the predictions surface
    under its internal name (npy bodies included); ``/send-feedback``
    walks the graph's feedback; the others call the root unit's method:
    ``/route`` answers the branch as a 1x1 tensor, ``/aggregate`` takes
    ``seldonMessages``. Bodies are raw JSON or the ``json=`` field of a
    form. Each call is an ``ingress:{method}`` span that continues the
    caller's ``traceparent``."""
    if method == "predict":
        return await engine_predictions(service, req)
    try:
        if method == "send-feedback":
            fb = feedback_from_dict(payload_obj(req, ErrorCode.ENGINE_INVALID_JSON))
            out = await service.send_feedback(fb, traceparent=req.headers.get("traceparent"))
            return WireResponse(body=message_to_json_fast(out))
        unit = service.executor.root.unit
        with service.tracer.request_trace(
            f"ingress:{method}",
            parent=req.headers.get("traceparent"),
            attrs={"deployment": service.deployment_name, "method": method},
        ):
            obj = payload_obj(req, ErrorCode.ENGINE_INVALID_JSON)
            if method == "transform-input":
                out = await unit.transform_input(message_from_dict(obj))
            elif method == "transform-output":
                out = await unit.transform_output(message_from_dict(obj))
            elif method == "route":
                branch = await unit.route(message_from_dict(obj))
                out = SeldonMessage.from_array(np.asarray([[branch]], dtype=np.float32))
            else:  # aggregate: the route table registers only INTERNAL_API_METHODS
                out = await unit.aggregate([message_from_dict(m) for m in obj.get("seldonMessages", [])])
        return WireResponse(body=message_to_json_fast(out))
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(e, method, service)


# ------------------------------------------------------------- gateway core


async def gateway_predictions(gw, req: WireRequest) -> WireResponse:
    """POST /api/v0.1/predictions through the OAuth gateway (reference
    apife RestClientController.prediction): the Bearer token's principal
    names the deployment, the backend predicts, the (request, response)
    pair goes to the audit sink. An npy body is answered in npy."""
    start = time.perf_counter()
    try:
        principal = gw.principal_from_auth(req.headers.get("authorization", ""))
        dep = gw.deployment_for(principal)
        # the predictors of one deployment share wire semantics (validated)
        sniff = dep.predictors[0].tpu.decode_npy_bindata if dep.predictors else True
        ctype = req.content_type
        kind = classify_binary_bytes(ctype, req.body, sniff)
        if kind != "json":
            msg = SeldonMessage(bin_data=req.body)
        elif ctype in ("application/json", ""):
            msg = message_from_json_fast(req.body)
        else:
            msg = message_from_dict(payload_obj(req, ErrorCode.APIFE_INVALID_JSON))
        out = await gw.backend.predict(dep, msg, wire_npy=kind == "npy", traceparent=req.headers.get("traceparent"))
        gw.audit.send(principal, msg, out)  # RestClientController.java:164
        if gw.metrics is not None:
            gw.metrics.ingress_request(dep.name, "predict", time.perf_counter() - start)
        if kind == "npy":
            from seldon_core_tpu_torch.serving.service import mirror_npy_kind

            out = mirror_npy_kind(out)
            if is_npy(out.bin_data):
                return npy_wire_response(out)
        return WireResponse(body=message_to_json_fast(out))
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(
            e, "gateway predict", fallback_code=ErrorCode.APIFE_MICROSERVICE_ERROR,
            metrics_error=None if gw.metrics is None else lambda c: gw.metrics.ingress_error("", "predict", c),
        )


async def gateway_feedback(gw, req: WireRequest) -> WireResponse:
    """POST /api/v0.1/feedback through the OAuth gateway."""
    start = time.perf_counter()
    try:
        principal = gw.principal_from_auth(req.headers.get("authorization", ""))
        dep = gw.deployment_for(principal)
        fb = feedback_from_dict(payload_obj(req, ErrorCode.APIFE_INVALID_JSON))
        out = await gw.backend.feedback(dep, fb)
        if gw.metrics is not None:
            gw.metrics.ingress_request(dep.name, "feedback", time.perf_counter() - start)
            gw.metrics.feedback(dep.name, "", "", fb.reward)
        return WireResponse(body=message_to_json_fast(out))
    except Exception as e:  # noqa: BLE001 - wire boundary
        return failure_response(
            e, "gateway feedback", fallback_code=ErrorCode.APIFE_MICROSERVICE_ERROR,
            metrics_error=None if gw.metrics is None else lambda c: gw.metrics.ingress_error("", "feedback", c),
        )


async def gateway_token(gw, req: WireRequest) -> WireResponse:
    """POST /oauth/token: client_credentials by Basic auth, an urlencoded
    form or a multipart form; 401 ``invalid_client`` on bad credentials."""
    client_id = client_secret = ""
    auth = req.headers.get("authorization", "")
    if auth.lower().startswith("basic "):
        try:
            client_id, _, client_secret = base64.b64decode(auth[6:]).decode().partition(":")
        except (ValueError, UnicodeDecodeError):
            client_id = client_secret = ""
    if not client_id:
        if req.content_type == "multipart/form-data":
            client_id = _multipart_field(req, "client_id") or ""
            client_secret = _multipart_field(req, "client_secret") or ""
        else:
            fields = parse_qs(req.body.decode("utf-8", errors="replace"))
            client_id = (fields.get("client_id") or [""])[0]
            client_secret = (fields.get("client_secret") or [""])[0]
    try:
        return WireResponse.json(gw.oauth.issue_token(client_id, client_secret))
    except PermissionError:
        return WireResponse.json({"error": "invalid_client", "error_description": "Bad client credentials"}, status=401)


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
        kind = classify_binary_bytes(req.content_type, req.body, service.decode_npy)
        msg = SeldonMessage(bin_data=req.body) if kind != "json" else _message(req)
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


def decode_fleet(service, req: WireRequest) -> WireResponse:
    """GET /decode/fleet: the replicated decode tier's per-arm states and
    lifecycle counters; 404 without one."""
    status = service.decode_fleet_status()
    if status is None:
        return WireResponse.json({"error": "no replicated decode tier"}, status=404)
    return WireResponse.json(status)


async def decode_drain(service, req: WireRequest) -> WireResponse:
    """POST /decode/drain[?replica=n]: drain the named arm (else the coldest
    serving one) and answer its result; 400 naming the parameter for a
    ``replica`` that is not an integer, and the APIException's status for a
    deployment without a fleet or an arm that cannot drain."""
    raw = req.query_param("replica")
    replica = None
    if raw is not None:
        try:
            replica = int(raw)
        except (TypeError, ValueError):
            return WireResponse.json(
                {"error": "?replica must be an integer arm id", "param": "replica", "got": raw}, status=400
            )
    try:
        return WireResponse.json(await service.drain_decode_replica(replica))
    except APIException as e:
        return WireResponse.json({"error": str(e)}, status=e.error.http_status)


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


# ------------------------------------------------------------- gRPC-Web
# The HTTP/1.1 form of gRPC (unary): each message is framed as one flags
# byte, a u32 big-endian length and the payload; the trailers travel as a
# last frame with the 0x80 flag. Served on the fast ingress, it gives
# gRPC-Web clients (browsers, envoy's grpc_web filter) the gateway without
# an HTTP/2 stack. The proto modules are imported inside the handlers: a
# host without protobuf answers a framed grpc-status 13 naming the module.

GRPC_WEB_CTYPE = "application/grpc-web+proto"

# CORS for browser gRPC-Web clients: the content type and the metadata
# headers are non-simple, so cross-origin browsers preflight; grpc-web JS
# also reads the response headers, so they are exposed
GRPC_WEB_CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "POST, OPTIONS",
    "Access-Control-Allow-Headers": "content-type, oauth_token, authorization, x-grpc-web, x-user-agent",
    "Access-Control-Expose-Headers": "grpc-status, grpc-message",
    "Access-Control-Max-Age": "86400",
}


def grpc_web_frame(flags: int, payload: bytes) -> bytes:
    return bytes([flags]) + len(payload).to_bytes(4, "big") + payload


def grpc_web_first_message(body: bytes) -> bytes:
    """The payload of the single DATA frame a unary request carries. A
    truncated frame, a trailer or compressed frame first, and bytes after
    the frame (client streaming on a unary method) are refused."""
    if len(body) < 5:
        raise ValueError("grpc-web frame truncated")
    if body[0] & 0x80:
        raise ValueError("grpc-web request began with a trailer frame")
    if body[0] & 0x01:
        raise ValueError("compressed grpc-web frames not supported")
    n = int.from_bytes(body[1:5], "big")
    if len(body) < 5 + n:
        raise ValueError("grpc-web frame length exceeds body")
    if len(body) > 5 + n:
        raise ValueError("trailing bytes after the unary request frame")
    return body[5 : 5 + n]


# the gRPC-Web routes: (path, method) under both package spellings
GRPC_WEB_ROUTES: tuple[tuple[str, str], ...] = tuple(
    (f"/{pkg}.Seldon/{method}", method) for pkg in ("seldon.tpu", "seldon.protos") for method in ("Predict", "SendFeedback")
)


def _grpc_web_response(message_pb: bytes, status: int = 0) -> WireResponse:
    body = grpc_web_frame(0, message_pb) + grpc_web_frame(0x80, f"grpc-status:{status}\r\n".encode())
    return WireResponse(body=body, content_type=GRPC_WEB_CTYPE, headers=dict(GRPC_WEB_CORS_HEADERS))


def _grpc_web_error(code: int, message: str) -> WireResponse:
    """A trailers-only answer (no DATA frame) for a transport-level
    failure: HTTP 200, the error in ``grpc-status``, the message
    percent-encoded so exception text cannot break the trailer block."""
    from urllib.parse import quote

    safe_msg = quote(message, safe=" ()[]{}<>=,.:;!?/'~@#$^&*+-_|")
    trailer = f"grpc-status:{code}\r\ngrpc-message:{safe_msg}\r\n".encode()
    return WireResponse(body=grpc_web_frame(0x80, trailer), content_type=GRPC_WEB_CTYPE,
                        headers=dict(GRPC_WEB_CORS_HEADERS))


def _grpc_web_principal(gw, req: WireRequest) -> str:
    """gRPC metadata are HTTP headers under gRPC-Web: the gateway's
    ``oauth_token`` key, else an ``Authorization: Bearer`` header."""
    token = req.headers.get("oauth_token", "")
    if token:
        principal = gw.oauth.principal(token)
        if not principal:
            raise APIException(ErrorCode.APIFE_GRPC_NO_PRINCIPAL_FOUND, "oauth_token")
        return principal
    return gw.principal_from_auth(req.headers.get("authorization", ""))


async def _grpc_web_call(gw, req: WireRequest, op: str, request_cls: str, serve) -> WireResponse:
    """Parse the unary frame into ``request_cls``, authenticate, run
    ``serve(principal, deployment, request_pb)`` and frame its SeldonMessage
    proto. Malformed framing or proto is grpc-status 3; an APIException is
    a failure SeldonMessage under grpc-status 0 (the native gateway's
    answer); anything else, a missing protobuf included, grpc-status 13."""
    start = time.perf_counter()
    try:
        from seldon_core_tpu_torch.core.codec_proto import message_to_proto
        from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    except ImportError as e:
        return _grpc_web_error(13, f"gRPC-Web needs {e.name}: {e}")  # 13 = INTERNAL
    try:
        request_pb = getattr(pb, request_cls).FromString(grpc_web_first_message(req.body))
    except Exception as e:  # noqa: BLE001 - malformed framing or proto
        return _grpc_web_error(3, f"invalid grpc-web request: {e}")  # 3 = INVALID_ARGUMENT
    try:
        principal = _grpc_web_principal(gw, req)
        dep = gw.deployment_for(principal)
        out = await serve(principal, dep, request_pb)
        if gw.metrics is not None:
            gw.metrics.ingress_request(dep.name, op, time.perf_counter() - start)
        return _grpc_web_response(message_to_proto(out).SerializeToString())
    except APIException as e:
        from seldon_core_tpu_torch.serving.grpc_server import failure_proto

        if gw.metrics is not None:
            gw.metrics.ingress_error("", op, e.error.code)
        return _grpc_web_response(failure_proto(e).SerializeToString())
    except Exception as e:  # noqa: BLE001 - wire boundary
        log.exception("grpc-web %s failed", op)
        if gw.metrics is not None:
            gw.metrics.ingress_error("", op, ErrorCode.APIFE_MICROSERVICE_ERROR.code)
        return _grpc_web_error(13, str(e))


async def gateway_grpc_web_predict(gw, req: WireRequest) -> WireResponse:
    """POST /seldon.*.Seldon/Predict as application/grpc-web+proto: the
    prediction is audited as on REST."""

    async def serve(principal, dep, request_pb):
        from seldon_core_tpu_torch.core.codec_proto import message_from_proto

        msg = message_from_proto(request_pb)
        out = await gw.backend.predict(dep, msg)
        gw.audit.send(principal, msg, out)
        return out

    return await _grpc_web_call(gw, req, "predict", "SeldonMessage", serve)


async def gateway_grpc_web_feedback(gw, req: WireRequest) -> WireResponse:
    """POST /seldon.*.Seldon/SendFeedback as application/grpc-web+proto,
    with the REST feedback's reward metric."""

    async def serve(principal, dep, request_pb):
        from seldon_core_tpu_torch.core.codec_proto import feedback_from_proto

        fb = feedback_from_proto(request_pb)
        out = await gw.backend.feedback(dep, fb)
        if gw.metrics is not None:
            gw.metrics.feedback(dep.name, "", "", fb.reward)
        return out

    return await _grpc_web_call(gw, req, "feedback", "Feedback", serve)
