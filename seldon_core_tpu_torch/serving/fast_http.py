"""Data-plane HTTP/1.1 ingress: a purpose-built asyncio.Protocol server.

Port of ``seldon_core_tpu/serving/fast_http.py`` on its pure-Python head
parser (``parse_head_py``; the JAX package's C parser is not carried over).
It serves exactly what the data plane needs: requests framed by
Content-Length, keep-alive, and a small exact-path route table. No chunked
request bodies (411 without Content-Length), no TLS, no websockets.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Mapping

from seldon_core_tpu_torch.serving.wire import WireRequest, WireResponse

log = logging.getLogger(__name__)

Handler = Callable[[WireRequest], Awaitable[WireResponse]]

_MAX_BODY = 64 * 1024 * 1024
_MAX_HEADER = 64 * 1024

# RFC 7230 3.2.6 token charset for header field-names
_TCHAR = frozenset(
    "!#$%&'*+-.^_`|~0123456789"
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
)

_STATUS_LINES = {
    200: b"HTTP/1.1 200 OK\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
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
            parsed = parse_head_py(bytes(self._buf[: _MAX_HEADER + 4]))
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
        path = head.path.split("?", 1)[0]
        req = WireRequest(method=head.method, path=path, headers=head.headers, body=body)
        keep_alive = head.headers.get("connection", "").lower() != "close"
        self._busy = True
        task = asyncio.ensure_future(self._run(self._routes.get((head.method, path)), req, keep_alive))
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

    async def feedback(req: WireRequest) -> WireResponse:
        return await wire.engine_feedback(service, req)

    async def ready(req: WireRequest) -> WireResponse:
        if state["paused"] or not service.executor.ready():
            return WireResponse.text("paused" if state["paused"] else "loading", 503)
        return WireResponse.text("ready")

    async def ping(req: WireRequest) -> WireResponse:
        return WireResponse.text("pong")

    return {
        ("POST", "/api/v0.1/predictions"): predictions,
        ("POST", "/api/v0.1/feedback"): feedback,
        ("GET", "/ready"): ready,
        ("GET", "/ping"): ping,
    }
