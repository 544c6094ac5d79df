"""A small HTTP/1.1 server on ``asyncio`` streams, shared by the OpenAI
front (``llm/http_service.py``) and the system status server
(``runtime/health.py``), plus the client GET that ``llm/fleet.py`` fans
out with. The reference runs both servers on aiohttp; the port has only
the standard library.

A request has a ``Content-Length`` body (or none); every response closes
its connection. A route is ``async def handler(request, exchange)`` keyed
by ``(method, path)``: it answers through the ``Exchange``. While a
handler runs, the server watches the client's side of the connection: a
client that goes away kills the request's context (``exchange.ctx``), so
an engine frees its slot, and cancels the handler. ``ssl_context`` serves
HTTPS.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import ssl
import urllib.parse
from http import HTTPStatus
from typing import Awaitable, Callable

from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("http_server")

JSON_TYPE = "application/json; charset=utf-8"
MAX_BODY_BYTES = 32 << 20
# A client that opens a connection and does not finish its request head
# and body in this time is dropped.
READ_TIMEOUT_S = 30.0


class BadRequest(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class Request:
    """One parsed request: method, path, query parameters, lower-cased
    headers and the body."""

    __slots__ = ("method", "path", "query", "headers", "body")

    def __init__(self, method: str, path: str, query: dict[str, str],
                 headers: dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body

    def json(self):
        """The body as JSON; ``ValueError`` when it is not."""
        return json.loads(self.body)


def error_body(message: str, err_type: str = "invalid_request_error",
               code: int = 400) -> tuple[int, dict]:
    """(status, OpenAI error body)."""
    return code, {"error": {"message": message, "type": err_type,
                            "param": None, "code": None}}


def head(code: int, content_type: str, length: int | None = None,
         extra: dict | None = None) -> bytes:
    lines = [f"HTTP/1.1 {code} {HTTPStatus(code).phrase}",
             f"Content-Type: {content_type}"]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    lines += [f"{k}: {v}" for k, v in (extra or {}).items()]
    lines += ["Connection: close", "", ""]
    return "\r\n".join(lines).encode("latin-1")


async def read_request(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> Request:
    """One request off the connection; ``BadRequest`` if malformed."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.LimitOverrunError:
        raise BadRequest(431, "request head too large") from None
    lines = raw.decode("latin-1").split("\r\n")
    try:
        method, target, _version = lines[0].split(" ", 2)
        headers = {}
        for line in lines[1:]:
            if line:
                name, value = line.split(":", 1)
                headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise BadRequest(400, "malformed request head") from None
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise BadRequest(411, "send the body with a Content-Length")
    if not 0 <= length <= MAX_BODY_BYTES:
        raise BadRequest(413, f"body of {length} bytes is over the "
                              f"{MAX_BODY_BYTES}-byte limit")
    if length and headers.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
    body = await reader.readexactly(length)
    path, _, qs = target.partition("?")
    query = dict(urllib.parse.parse_qsl(qs, keep_blank_values=True))
    return Request(method.upper(), path, query, headers, body)


async def _until_eof(reader: asyncio.StreamReader) -> None:
    """Return when the client's side of the connection is closed."""
    with contextlib.suppress(ConnectionError):
        while await reader.read(1 << 16):
            pass


class Exchange:
    """One request/response on one connection: where the handler writes,
    and the context of the request it started, if any."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.ctx = None
        self.streaming = False  # the 200 head of a stream is out
        # Headers every response head of this exchange carries (the
        # front's X-Overload-Brownout), and the overload defense's
        # admission permit of its request.
        self.headers: dict = {}
        self.permit = None

    async def send(self, code: int, content_type: str, body: bytes,
                   extra: dict | None = None) -> None:
        self.writer.write(head(code, content_type, len(body),
                               {**self.headers, **(extra or {})}) + body)
        await self.writer.drain()

    async def send_json(self, code: int, payload: dict,
                        extra: dict | None = None) -> None:
        await self.send(code, JSON_TYPE, json.dumps(payload).encode(), extra)

    async def start_stream(self, extra: dict | None = None) -> None:
        """The 200 head of a server-sent event stream."""
        self.writer.write(head(200, "text/event-stream",
                               extra={"Cache-Control": "no-cache",
                                      **self.headers, **(extra or {})}))
        self.streaming = True

    async def write(self, data: bytes) -> None:
        self.writer.write(data)
        await self.writer.drain()


Handler = Callable[[Request, Exchange], Awaitable[None]]


class HttpServer:
    """Routes ``(method, path)`` to handlers on one listening socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ssl_context: ssl.SSLContext | None = None):
        self.host, self.port = host, port
        self.ssl_context = ssl_context
        self.routes: dict[tuple[str, str], Handler] = {}
        self._server: asyncio.Server | None = None
        self._connections: set[asyncio.Task] = set()

    def add(self, method: str, path: str, handler: Handler) -> None:
        self.routes[(method, path)] = handler

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._connection, self.host, self.port, ssl=self.ssl_context)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for task in list(self._connections):
            task.cancel()
        await asyncio.gather(*self._connections, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def not_found(self, req: Request, ex: Exchange) -> None:
        await ex.send_json(*error_body(f"no route {req.method} {req.path}",
                                       "not_found", 404))

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        ex = Exchange(writer)
        try:
            try:
                req = await asyncio.wait_for(read_request(reader, writer),
                                             READ_TIMEOUT_S)
            except BadRequest as exc:
                await ex.send_json(*error_body(str(exc), code=exc.code))
                return
            except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                    ConnectionError, ssl.SSLError):
                return
            route = self.routes.get((req.method, req.path), self.not_found)
            handler = asyncio.ensure_future(route(req, ex))
            gone = asyncio.ensure_future(_until_eof(reader))
            try:
                await asyncio.wait({handler, gone},
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                if not handler.done():
                    # The client went away (or the server stops): kill
                    # the request so the engine frees its slot.
                    if ex.ctx is not None:
                        ex.ctx.kill()
                    handler.cancel()
                gone.cancel()
                await asyncio.gather(handler, gone, return_exceptions=True)
            if not handler.cancelled() and handler.exception() is not None:
                exc = handler.exception()
                if not isinstance(exc, ConnectionError):
                    log.error("%s %s failed", req.method, req.path,
                              exc_info=exc)
        finally:
            writer.close()
            self._connections.discard(task)


async def http_get_json(addr: str, path: str,
                        timeout_s: float) -> tuple[int, object]:
    """GET ``http://addr/path`` and parse the JSON body: (status, body).
    Raises ``OSError``, ``asyncio.TimeoutError`` or ``ValueError``."""
    host, _, port = addr.rpartition(":")

    async def fetch() -> bytes:
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            writer.write(f"GET {path} HTTP/1.1\r\nHost: {addr}\r\n"
                         "Connection: close\r\n\r\n".encode("latin-1"))
            await writer.drain()
            return await reader.read()
        finally:
            writer.close()

    raw = await asyncio.wait_for(fetch(), timeout_s)
    head_part, _, body = raw.partition(b"\r\n\r\n")
    status = int(head_part.split(b" ", 2)[1])
    return status, json.loads(body) if body else None
