"""Pooled keep-alive HTTP/1.1 client on asyncio streams.

The transport of the port's data plane, in place of the aiohttp client
the JAX package uses (``engine/remote.py::_RestSession``,
``gateway/app.py::RemoteBackend``): a unit's REST hop, the gateway's hop
to a remote engine, and the load generator's token fetch. Standard
library only, so a client process stays light.

- ``RawHttpConn``: one persistent connection; requests go out as
  pre-built bytes (the load generator builds each body once and re-posts
  it). A response is framed by ``Content-Length``, by chunked transfer
  coding, or by the server closing the connection; a 204 or 304 has none.
- ``HttpPool``: connections kept alive per (host, port), at most
  ``limit`` open in all (150, the reference's pool size), with a connect
  timeout and a total timeout per request that a caller may replace (with
  a request's remaining deadline budget). A pooled connection the server
  has closed is dropped before reuse; one that dies under a request fails
  that request as a transport error (``ConnectionError``, ``OSError`` or
  ``TimeoutError``), never a hang.
- ``PoolPerLoop``: one pool per running event loop, rebuilt when the loop
  changes (each asyncio.run, each test), never reused across loops.

No TLS, no redirects, no cookies, no proxies: nothing the JAX package
asked of aiohttp.
"""

from __future__ import annotations

import asyncio
import collections
import json
from typing import Callable
from urllib.parse import urlencode, urlsplit

POOL_LIMIT = 150  # the reference's connection pool (InternalPredictionService.java:60-61)


class HttpResponse:
    """A finished response: status, lower-case headers, body bytes."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: dict, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";", 1)[0].strip().lower()

    def json(self):
        return json.loads(self.body)


class RawHttpConn:
    """One persistent HTTP/1.1 connection over asyncio streams.

    ``exchange`` makes one round trip and raises on any failure (closing
    the connection); ``request_raw`` reconnects once when a kept-alive
    connection turns out dead, which a closed-loop load generator wants
    and a pooled client leaves to its caller's retry policy."""

    def __init__(self, host: str, port: int, use_tls: bool = False):
        self.host, self.port = host, port
        self.use_tls = use_tls
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=True if self.use_tls else None
        )

    @property
    def connected(self) -> bool:
        return self._writer is not None

    def reusable(self) -> bool:
        """Open, and the server has not closed its end (a FIN already read)."""
        return (
            self._writer is not None
            and not self._writer.is_closing()
            and not self._reader.at_eof()
        )

    def build_request(
        self, path: str, body: bytes, content_type: str, extra_headers: dict, method: str = "POST"
    ) -> bytes:
        lines = [
            f"{method} {path} HTTP/1.1",
            f"Host: {self.host}:{self.port}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: keep-alive",
        ]
        lines.extend(f"{k}: {v}" for k, v in extra_headers.items())
        return ("\r\n".join(lines) + "\r\n\r\n").encode() + body

    async def _read_body(self, headers: dict) -> tuple[bytes, bool]:
        """(body, keep) by the response's framing: chunked, Content-Length,
        or to EOF (the connection then cannot be reused)."""
        reader = self._reader
        if "chunked" in headers.get("transfer-encoding", "").lower():
            parts = []
            while True:
                size_line = await reader.readline()
                if not size_line:
                    raise ConnectionResetError("server closed mid chunked body")
                size = int(size_line.split(b";", 1)[0].strip(), 16)
                if size == 0:
                    while True:  # trailers, up to the blank line
                        line = await reader.readline()
                        if line in (b"\r\n", b"\n", b""):
                            break
                    return b"".join(parts), True
                parts.append(await reader.readexactly(size))
                await reader.readexactly(2)  # the chunk's CRLF
        if "content-length" in headers:
            clen = int(headers["content-length"])
            return (await reader.readexactly(clen) if clen else b""), True
        return await reader.read(), False

    async def exchange(self, req: bytes) -> tuple[int, dict, bytes]:
        """Send pre-built request bytes; returns (status, lower-case
        headers, body). Any failure closes the connection and raises."""
        ok = False
        try:
            if self._writer is None:
                await self.connect()
            self._writer.write(req)
            await self._writer.drain()
            status_line = await self._reader.readline()
            if not status_line:
                raise ConnectionResetError("server closed the keep-alive connection")
            try:
                status = int(status_line.split(b" ", 2)[1])
            except (IndexError, ValueError):
                raise ConnectionError(f"malformed status line {status_line[:80]!r}") from None
            headers: dict = {}
            while True:
                line = await self._reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            # a 204 or 304 has no body whatever its headers say (RFC 7230 3.3.3)
            body, keep = (b"", True) if status in (204, 304) else await self._read_body(headers)
            ok = keep and headers.get("connection", "").lower() != "close"
            return status, headers, body
        except asyncio.IncompleteReadError as e:
            raise ConnectionResetError(f"server closed mid response: {e}") from None
        finally:
            if not ok:
                await self.close()

    async def request_raw(self, req: bytes) -> tuple[int, dict, bytes]:
        """``exchange``, reconnecting ONCE on a dead keep-alive connection."""
        for attempt in (0, 1):
            try:
                return await self.exchange(req)
            except (ConnectionError, OSError):
                if attempt:
                    raise
        raise ConnectionError("unreachable")

    async def post(
        self, path: str, body: bytes, content_type: str, extra_headers: dict
    ) -> tuple[int, dict, bytes]:
        return await self.request_raw(self.build_request(path, body, content_type, extra_headers))

    async def close(self) -> None:
        writer, self._reader, self._writer = self._writer, None, None
        if writer is not None:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - already-dead socket or loop
                pass


def split_url(url: str) -> tuple[str, int, str]:
    """(host, port, path with query) of an http:// URL."""
    u = urlsplit(url)
    if u.scheme != "http":
        raise ValueError(f"only http:// URLs are served by this client, got {url!r}")
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    return u.hostname or "127.0.0.1", u.port or 80, path


class HttpPool:
    """Keep-alive connections per (host, port), at most ``limit`` open in
    all. Bound to the event loop it is used on (``PoolPerLoop`` keeps one
    per loop)."""

    def __init__(self, *, limit: int = POOL_LIMIT, connect_timeout_s: float = 1.0, total_timeout_s: float = 5.0):
        self.limit = limit
        self.connect_timeout_s = connect_timeout_s
        self.total_timeout_s = total_timeout_s
        self._idle: dict[tuple[str, int], collections.deque] = {}
        self._open = 0
        self._waiters: collections.deque = collections.deque()
        self.closed = False

    @property
    def open_connections(self) -> int:
        return self._open

    async def _acquire(self, key: tuple[str, int]) -> RawHttpConn:
        while True:
            if self.closed:
                raise ConnectionError("HTTP pool is closed")
            idle = self._idle.get(key)
            while idle:
                conn = idle.pop()
                if conn.reusable():
                    return conn
                await self._drop(conn)
            if self._open < self.limit:
                self._open += 1
                return RawHttpConn(*key)
            victim = next((d for d in self._idle.values() if d), None)
            if victim is not None:  # the limit is reached: close another host's idle one
                await self._drop(victim.popleft())
                continue
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append(fut)
            try:
                await fut
            finally:
                if fut in self._waiters:
                    self._waiters.remove(fut)

    async def _drop(self, conn: RawHttpConn) -> None:
        await conn.close()
        self._open -= 1
        self._wake()

    def _wake(self) -> None:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return

    async def request(
        self,
        method: str,
        url: str,
        body: bytes = b"",
        headers: dict | None = None,
        *,
        content_type: str = "application/json",
        timeout_s: float | None = None,
    ) -> HttpResponse:
        """One request. ``timeout_s`` replaces the pool's total timeout
        (connect stays bounded by the pool's connect timeout). Raises
        ``ConnectionError``/``OSError`` on a transport failure and
        ``TimeoutError`` past a timeout."""
        host, port, path = split_url(url)
        key = (host, port)
        total = self.total_timeout_s if timeout_s is None else timeout_s
        conn = await self._acquire(key)
        reuse = False
        try:
            async with asyncio.timeout(total):
                if not conn.connected:
                    try:
                        async with asyncio.timeout(self.connect_timeout_s):
                            await conn.connect()
                    except TimeoutError:
                        raise TimeoutError(f"connect to {host}:{port} timed out after {self.connect_timeout_s}s")
                status, resp_headers, resp_body = await conn.exchange(
                    conn.build_request(path, body, content_type, headers or {}, method)
                )
            reuse = conn.reusable()
            return HttpResponse(status, resp_headers, resp_body)
        finally:
            if reuse and not self.closed:
                self._idle.setdefault(key, collections.deque()).append(conn)
                self._wake()
            else:
                await self._drop(conn)

    async def post(self, url: str, body: bytes, headers: dict | None = None, **kw) -> HttpResponse:
        return await self.request("POST", url, body, headers, **kw)

    async def post_form(self, url: str, fields: dict, headers: dict | None = None, **kw) -> HttpResponse:
        """POST an application/x-www-form-urlencoded body."""
        return await self.request(
            "POST", url, urlencode(fields).encode(), headers,
            content_type="application/x-www-form-urlencoded", **kw,
        )

    async def close(self) -> None:
        self.closed = True
        for idle in self._idle.values():
            while idle:
                await self._drop(idle.popleft())
        for fut in self._waiters:
            if not fut.done():
                fut.set_result(None)


class PoolPerLoop:
    """One ``HttpPool`` per running event loop: ``get`` builds it on first
    use and again whenever the loop differs from the one it was built on
    (the stale pool's sockets belong to a dead loop and are closed
    best-effort). ``get`` and ``close`` are serialized by a per-loop lock,
    so a close overlapping a get never hands back a pool being closed."""

    def __init__(self, make_pool: Callable[[], HttpPool]):
        self._make_pool = make_pool
        self._pool: HttpPool | None = None
        self._pool_loop = None
        self._lock: asyncio.Lock | None = None
        self._lock_loop = None

    def _get_lock(self) -> asyncio.Lock:
        loop = asyncio.get_running_loop()
        if self._lock is None or self._lock_loop is not loop:
            self._lock, self._lock_loop = asyncio.Lock(), loop
        return self._lock

    async def get(self) -> HttpPool:
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            if self._pool is None or self._pool.closed or self._pool_loop is not loop:
                stale = self._pool
                if stale is not None and not stale.closed:
                    try:
                        await stale.close()
                    except Exception:  # noqa: BLE001 - sockets of a dead loop
                        pass
                self._pool, self._pool_loop = self._make_pool(), loop
            return self._pool

    async def close(self) -> None:
        async with self._get_lock():
            pool, self._pool, self._pool_loop = self._pool, None, None
            if pool is not None and not pool.closed:
                try:
                    await pool.close()
                except Exception:  # noqa: BLE001 - a pool built on a dead loop
                    pass
