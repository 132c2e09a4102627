"""Data-plane HTTP/1.1 ingress: a purpose-built asyncio.Protocol server.

Port of ``seldon_core_tpu/serving/fast_http.py``. A request head is parsed
in one C pass (``native.parse_http_head``) and put under the framing policy
by ``head_from_c``; where the native library is missing, or declines a head
whose captured values may be cut, the pure-Python ``parse_head_py`` parses
it, and stays the semantic source both must agree with. It serves exactly
what the data plane needs: requests framed by
Content-Length, keep-alive, a small exact-path route table (a route ending
in ``/*`` takes one more path segment), and chunked responses for the
generative tier's per-token SSE route. No chunked request bodies (411
without Content-Length), no TLS, no websockets.

Besides the data plane it serves ``/pause`` and ``/unpause`` (GET or
POST; after ``/pause``, ``/ready`` answers 503 ``paused``) and the
telemetry read-outs: ``/metrics`` and
``/prometheus``, and the trace, flight and profile routes that the JAX
package serves on its operator API (``serving/wire.py``), and the
replicated decode fleet's ``GET /decode/fleet`` and ``POST
/decode/drain[?replica=n]``, and the reference's internal microservice
API (``/predict``, ``/route``, ``/send-feedback``, ``/transform-input``,
``/transform-output``, ``/aggregate``), so every served graph can be a
remote engine's unit. ``gateway_routes`` is the OAuth gateway's table,
gRPC-Web's unary routes and their CORS preflight included.

The C parser captures only ``Content-Type`` and ``Authorization``; the
other headers a handler reads (gRPC-Web's ``oauth_token``, ``traceparent``,
``Accept`` and, when the C parser saw ``Connection: close``, the last
``Connection``) are read from the head it validated by ``_header_from_head``
(the JAX package's scan, the last duplicate winning as in the Python
parser), so both paths hand a handler the same values.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Mapping

from seldon_core_tpu_torch.serving.wire import WireRequest, WireResponse, WireStreamResponse

log = logging.getLogger(__name__)

Handler = Callable[[WireRequest], Awaitable["WireResponse | WireStreamResponse"]]

_MAX_BODY = 64 * 1024 * 1024
_MAX_HEADER = 64 * 1024

# RFC 7230 3.2.6 token charset for header field-names
_TCHAR = frozenset(
    "!#$%&'*+-.^_`|~0123456789"
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
)

_STATUS_LINES = {
    200: b"HTTP/1.1 200 OK\r\n",
    204: b"HTTP/1.1 204 No Content\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
    401: b"HTTP/1.1 401 Unauthorized\r\n",
    404: b"HTTP/1.1 404 Not Found\r\n",
    411: b"HTTP/1.1 411 Length Required\r\n",
    413: b"HTTP/1.1 413 Payload Too Large\r\n",
    500: b"HTTP/1.1 500 Internal Server Error\r\n",
    503: b"HTTP/1.1 503 Service Unavailable\r\n",
    504: b"HTTP/1.1 504 Gateway Timeout\r\n",
}


def _status_line(code: int) -> bytes:
    return _STATUS_LINES.get(code) or f"HTTP/1.1 {code} Status\r\n".encode()


class PyHead:
    """One accepted request head."""

    __slots__ = ("method", "path", "headers", "clen", "body_start")

    def __init__(self, method, path, headers, clen, body_start):
        self.method = method
        self.path = path
        self.headers = headers
        self.clen = clen
        self.body_start = body_start


def parse_head_py(raw: bytes) -> "PyHead | int | tuple[int, bytes]":
    """Head parse + framing policy as a pure function: a PyHead (accepted;
    the body may still be streaming in), 0 (head incomplete — read more),
    or ``(status, message)`` to reject."""
    head_end = raw.find(b"\r\n\r\n")
    if head_end < 0:
        if len(raw) > _MAX_HEADER:
            return (400, b"header too large")
        return 0
    lines = raw[:head_end].split(b"\r\n")
    if any(b"\n" in ln or b"\r" in ln for ln in lines):
        # bare LF/CR in the head: an LF-tolerant proxy would see other lines
        return (400, b"bad line terminator")
    try:
        method, path, _ = lines[0].decode("latin-1").split(" ", 2)
    except ValueError:
        return (400, b"bad request line")
    if not method or not path:
        return (400, b"bad request line")
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if line[:1] in (b" ", b"\t"):
            return (400, b"bad header name")  # obs-fold
        k, sep, v = line.decode("latin-1").partition(":")
        if not sep:
            continue
        if not k or any(c not in _TCHAR for c in k):
            return (400, b"bad header name")
        key = k.lower()
        v = v.strip(" \t")  # OWS is SP/HT only (RFC 7230 3.2.3)
        if key == "content-length":
            if not (v.isascii() and v.isdigit()):
                return (400, b"bad content-length")
            if key in headers and int(headers[key]) != int(v):
                return (400, b"conflicting content-length")
        headers[key] = v
    if "transfer-encoding" in headers:
        # never frame a TE request by CL (request-smuggling desync)
        return (400, b"Transfer-Encoding not supported")
    if "content-length" in headers:
        clen = int(headers["content-length"])
    elif method in ("GET", "HEAD", "DELETE", "OPTIONS"):
        clen = 0
    else:
        return (411, b"Content-Length required")
    if clen > _MAX_BODY:
        return (413, b"body too large")
    return PyHead(method, path, headers, clen, head_end + 4)


# the headers a handler reads besides the two the C parser captures
_SCANNED_HEADERS = (b"oauth_token", b"traceparent", b"accept")


def _header_from_head(head: bytes, name: bytes) -> str | None:
    """One header's value from a head the C parser has validated (CRLF
    lines, token field-names, no obs-fold): the last duplicate wins, as in
    the Python parser's dict and the C parser's captured headers."""
    target = name + b":"
    found: str | None = None
    for line in head.split(b"\r\n")[1:]:
        if line[: len(target)].lower() == target:
            found = line[len(target):].strip(b" \t").decode("latin-1")
    return found


def head_from_c(parsed, raw: bytes) -> "PyHead | int | tuple[int, bytes]":
    """``native.parse_http_head(raw)``'s result (not None) under
    ``parse_head_py``'s framing policy, with its return contract: a PyHead,
    0 (incomplete) or ``(status, message)``. Any Transfer-Encoding is
    refused, even beside a Content-Length (never frame a TE request by CL)."""
    from seldon_core_tpu_torch import native

    if parsed == 0:
        return (400, b"header too large") if len(raw) > _MAX_HEADER else 0
    if parsed == -1:
        return (400, b"bad request")
    flags = parsed.flags
    if flags & native.HDRF_HAS_TE:
        return (400, b"Transfer-Encoding not supported")
    if flags & native.HDRF_HAS_CLEN:
        clen = parsed.content_length
    elif parsed.method in ("GET", "HEAD", "DELETE", "OPTIONS"):
        clen = 0
    else:
        return (411, b"Content-Length required")
    if clen > _MAX_BODY:
        return (413, b"body too large")
    headers: dict[str, str] = {}
    if parsed.content_type is not None:
        headers["content-type"] = parsed.content_type
    if parsed.authorization is not None:
        headers["authorization"] = parsed.authorization
    head = raw[: parsed.body_start - 2]
    low = head.lower()
    names = _SCANNED_HEADERS + ((b"connection",) if flags & native.HDRF_CONN_CLOSE else ())
    for name in names:
        # one find in the lowered head first: a request without the header
        # is not split into lines
        if b"\r\n" + name + b":" in low:
            value = _header_from_head(head, name)
            if value is not None:
                headers[name.decode()] = value
    return PyHead(parsed.method, parsed.path, headers, clen, parsed.body_start)


def parse_head(raw: bytes) -> "PyHead | int | tuple[int, bytes]":
    """The C parse under the framing policy, or ``parse_head_py`` where the
    native library is missing or declines the head."""
    from seldon_core_tpu_torch import native

    parsed = native.parse_http_head(raw)
    if parsed is None:
        return parse_head_py(raw)
    return head_from_c(parsed, raw)


def _route(routes: Mapping[tuple[str, str], Handler], method: str, path: str) -> Handler | None:
    """The exact route, else the ``/*`` route of the path's parent."""
    handler = routes.get((method, path))
    if handler is None and "/" in path[1:]:
        handler = routes.get((method, path[: path.rindex("/") + 1] + "*"))
    return handler


class HttpProtocol(asyncio.Protocol):
    """One connection. Requests are processed strictly in order: parse ->
    run the handler task -> write the response -> parse the next. Bytes
    that arrive while a handler runs are buffered."""

    def __init__(self, routes: Mapping[tuple[str, str], Handler]):
        self._routes = routes
        self._transport: asyncio.Transport | None = None
        self._buf = bytearray()
        self._busy = False
        self._closing = False
        self._pending_head: PyHead | None = None  # head parsed, body incoming

    def connection_made(self, transport: asyncio.BaseTransport) -> None:
        self._transport = transport  # type: ignore[assignment]

    def connection_lost(self, exc: Exception | None) -> None:
        self._closing = True
        self._transport = None

    def data_received(self, data: bytes) -> None:
        self._buf += data
        if not self._busy:
            self._try_dispatch()

    def _try_dispatch(self) -> None:
        if self._pending_head is None:
            # only the head region is copied: copying the whole buffer per
            # TCP chunk would make large uploads O(n^2)
            parsed = parse_head(bytes(self._buf[: _MAX_HEADER + 4]))
            if parsed == 0:
                return
            if isinstance(parsed, tuple):
                status, text = parsed
                self._respond_simple(status, text)
                self._close()
                return
            self._pending_head = parsed
        head = self._pending_head
        if len(self._buf) - head.body_start < head.clen:
            return  # wait for the rest of the body
        self._pending_head = None
        body = bytes(self._buf[head.body_start : head.body_start + head.clen])
        del self._buf[: head.body_start + head.clen]
        path, _, query = head.path.partition("?")
        req = WireRequest(method=head.method, path=path, headers=head.headers, body=body, query=query)
        keep_alive = head.headers.get("connection", "").lower() != "close"
        self._busy = True
        task = asyncio.ensure_future(self._run(_route(self._routes, head.method, path), req, keep_alive))
        task.add_done_callback(self._on_handler_done)

    async def _run(self, handler: Handler | None, req: WireRequest, keep_alive: bool) -> None:
        if handler is None:
            self._respond_simple(404, b"not found", keep_alive)
            return
        try:
            resp = await handler(req)
        except Exception:  # noqa: BLE001 - handlers should not raise; answer anyway
            log.exception("ingress handler failed for %s", req.path)
            resp = WireResponse(status=500, body=b'{"status":"FAILURE"}')
        if isinstance(resp, WireStreamResponse):
            await self._write_stream(resp, keep_alive)
        else:
            self._write_response(resp, keep_alive)

    def _on_handler_done(self, task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            log.error("ingress task error: %s", task.exception())
        self._busy = False
        if self._transport is not None and not self._closing and self._buf:
            self._try_dispatch()

    def _write_response(self, resp: WireResponse, keep_alive: bool = True) -> None:
        t = self._transport
        if t is None:
            return
        extra = b"".join(f"{k}: {v}\r\n".encode() for k, v in resp.headers.items())
        if resp.status == 204:
            # RFC 7230 3.3.2: a 204 (a CORS preflight's answer) carries no
            # Content-Length and no body
            t.write(
                _status_line(204)
                + extra
                + (b"Connection: keep-alive\r\n\r\n" if keep_alive else b"Connection: close\r\n\r\n")
            )
            if not keep_alive:
                self._close()
            return
        t.write(
            _status_line(resp.status)
            + b"Content-Type: " + resp.content_type.encode() + b"\r\n"
            + b"Content-Length: " + str(len(resp.body)).encode() + b"\r\n"
            + extra
            + (b"Connection: keep-alive\r\n\r\n" if keep_alive else b"Connection: close\r\n\r\n")
            + resp.body
        )
        if not keep_alive:
            self._close()

    async def _write_stream(self, resp: WireStreamResponse, keep_alive: bool = True) -> None:
        """A streaming (SSE) response under Transfer-Encoding: chunked, each
        event one chunk written as it is produced. A client that vanishes
        mid-stream ends the loop; the event source is closed either way, so
        its generation is cancelled rather than left running."""
        t = self._transport
        try:
            if t is None:
                return
            extra = b"".join(f"{k}: {v}\r\n".encode() for k, v in resp.headers.items())
            t.write(
                _status_line(resp.status)
                + b"Content-Type: " + resp.content_type.encode() + b"\r\n"
                + b"Transfer-Encoding: chunked\r\n"
                + b"Cache-Control: no-cache\r\n"
                + extra
                + (b"Connection: keep-alive\r\n\r\n" if keep_alive else b"Connection: close\r\n\r\n")
            )
            async for chunk in resp.events:
                if self._transport is None or self._closing:
                    break
                if chunk:
                    self._transport.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
        finally:
            await resp.events.aclose()
            if self._transport is not None and not self._closing:
                self._transport.write(b"0\r\n\r\n")
                if not keep_alive:
                    self._close()

    def _respond_simple(self, status: int, text: bytes, keep_alive: bool = False) -> None:
        self._write_response(
            WireResponse(status=status, body=text, content_type="text/plain"), keep_alive
        )

    def _close(self) -> None:
        self._closing = True
        if self._transport is not None:
            self._transport.close()


async def start_fast_server(
    routes: Mapping[tuple[str, str], Handler], host: str, port: int
) -> asyncio.AbstractServer:
    loop = asyncio.get_running_loop()
    return await loop.create_server(lambda: HttpProtocol(routes), host, port)


def engine_routes(service, state: dict) -> dict:
    """The engine data-plane route table."""
    from seldon_core_tpu_torch.serving import wire

    async def predictions(req: WireRequest) -> WireResponse:
        return await wire.engine_predictions(service, req)

    async def predictions_stream(req: WireRequest):
        return await wire.engine_predictions_stream(service, req)

    async def feedback(req: WireRequest) -> WireResponse:
        return await wire.engine_feedback(service, req)

    async def ready(req: WireRequest) -> WireResponse:
        if state["paused"] or not service.executor.ready():
            return WireResponse.text("paused" if state["paused"] else "loading", 503)
        return WireResponse.text("ready")

    async def ping(req: WireRequest) -> WireResponse:
        return WireResponse.text("pong")

    async def pause(req: WireRequest) -> WireResponse:
        state["paused"] = True  # /ready answers 503 "paused": load balancers drain
        return WireResponse.text("paused")

    async def unpause(req: WireRequest) -> WireResponse:
        state["paused"] = False
        return WireResponse.text("unpaused")

    async def prometheus(req: WireRequest) -> WireResponse:
        return wire.metrics_response(service.metrics, req)

    async def decode_fleet(req: WireRequest) -> WireResponse:
        return wire.decode_fleet(service, req)

    async def decode_drain(req: WireRequest) -> WireResponse:
        return await wire.decode_drain(service, req)

    def read_out(fn):
        async def handler(req: WireRequest) -> WireResponse:
            return fn(req)

        return handler

    routes = {
        ("POST", "/api/v0.1/predictions"): predictions,
        ("POST", "/api/v0.1/predictions/stream"): predictions_stream,
        ("POST", "/api/v0.1/feedback"): feedback,
        ("GET", "/ready"): ready,
        ("GET", "/ping"): ping,
        ("GET", "/metrics"): prometheus,
        ("GET", "/prometheus"): prometheus,
        ("GET", "/traces"): read_out(wire.traces_list),
        ("GET", "/traces/*"): read_out(wire.trace_get),
        ("GET", "/decode/flight"): read_out(wire.decode_flight),
        ("GET", "/decode/health"): read_out(wire.decode_health),
        ("GET", "/decode/profile"): read_out(wire.decode_profile),
        ("GET", "/decode/fleet"): decode_fleet,
        ("POST", "/decode/drain"): decode_drain,
    }
    for method in ("GET", "POST"):
        routes[(method, "/pause")] = pause
        routes[(method, "/unpause")] = unpause

    # the reference's internal microservice API: what a remote engine's
    # RemoteUnit calls on this graph
    def unit_method(name: str):
        async def handler(req: WireRequest) -> WireResponse:
            return await wire.engine_unit_method(service, req, name)

        return handler

    for name in wire.INTERNAL_API_METHODS:
        routes[("POST", f"/{name}")] = unit_method(name)
    return routes


def gateway_routes(gw) -> dict:
    """The OAuth gateway's route table (``gateway/app.py``): the token
    route, the Bearer-authenticated predictions and feedback, gRPC-Web's
    ``Seldon.Predict`` and ``Seldon.SendFeedback`` under both package
    spellings (``wire.GRPC_WEB_ROUTES``) with their OPTIONS preflight,
    health and the gateway's metrics."""
    from seldon_core_tpu_torch.serving import wire

    async def predictions(req: WireRequest) -> WireResponse:
        return await wire.gateway_predictions(gw, req)

    async def feedback(req: WireRequest) -> WireResponse:
        return await wire.gateway_feedback(gw, req)

    async def token(req: WireRequest) -> WireResponse:
        return await wire.gateway_token(gw, req)

    async def ready(req: WireRequest) -> WireResponse:
        return WireResponse.text("ready")

    async def ping(req: WireRequest) -> WireResponse:
        return WireResponse.text("pong")

    async def prometheus(req: WireRequest) -> WireResponse:
        return wire.metrics_response(gw.metrics, req)

    async def grpc_web_predict(req: WireRequest) -> WireResponse:
        return await wire.gateway_grpc_web_predict(gw, req)

    async def grpc_web_feedback(req: WireRequest) -> WireResponse:
        return await wire.gateway_grpc_web_feedback(gw, req)

    async def grpc_web_preflight(req: WireRequest) -> WireResponse:
        # browsers preflight the non-simple content type and metadata
        # headers with OPTIONS before the POST
        return WireResponse(status=204, content_type="text/plain", headers=dict(wire.GRPC_WEB_CORS_HEADERS))

    routes = {
        ("POST", "/api/v0.1/predictions"): predictions,
        ("POST", "/api/v0.1/feedback"): feedback,
        ("POST", "/oauth/token"): token,
        ("GET", "/ready"): ready,
        ("GET", "/ping"): ping,
        ("GET", "/metrics"): prometheus,
        ("GET", "/prometheus"): prometheus,
    }
    for path, method in wire.GRPC_WEB_ROUTES:
        routes[("OPTIONS", path)] = grpc_web_preflight
        routes[("POST", path)] = grpc_web_predict if method == "Predict" else grpc_web_feedback
    return routes
