"""OpenAI-compatible HTTP front on ``asyncio`` streams (the routes, bodies
and error statuses of ``dynamo_tpu.llm.http_service``, without aiohttp).

Routes: ``POST /v1/chat/completions`` and ``POST /v1/completions``
(streamed as server-sent events, ``data: {json}\\n\\n`` then
``data: [DONE]\\n\\n``, or not streamed), ``GET /v1/models``, ``GET
/health`` and ``GET /live``. Errors are OpenAI error bodies: 400 for a
body that does not parse or validate and for ``ValueError`` /
``InvalidRequestError`` from the pipeline, 404 for an unknown model, 404
``adapter_not_found`` when a model name resolves to a LoRA adapter its
worker does not hold (``AdapterNotFoundError``), 503
with ``Retry-After: 1`` when a routed model has no live worker
(``NoInstancesError``), 503 ``overloaded`` with ``Retry-After: 1`` when
the KV router finds every worker above its busy threshold
(``OverloadedError``), 500 otherwise. A streamed response pulls its
first chunk before it sends headers, so pipeline errors keep their
status.

HTTP/1.1 with a ``Content-Length`` request body; every response closes
its connection. A client that goes away (its side of the connection
reaches EOF, or a write fails) kills the request's context, so the engine
frees the slot.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
from http import HTTPStatus
from typing import AsyncIterator, Callable

from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.preprocessor import aggregate_chat_stream
from dynamo_tpu_torch.llm.protocols import (ChatCompletionRequest,
                                            CompletionRequest, usage_block)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import (AdapterNotFoundError,
                                             InvalidRequestError,
                                             NoInstancesError,
                                             OverloadedError)
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("http")

JSON_TYPE = "application/json; charset=utf-8"
MAX_BODY_BYTES = 32 << 20
# A client that opens a connection and does not finish its request head
# and body in this time is dropped.
READ_TIMEOUT_S = 30.0


def _error_body(message: str, err_type: str = "invalid_request_error",
                code: int = 400) -> tuple[int, dict]:
    return code, {"error": {"message": message, "type": err_type,
                            "param": None, "code": None}}


class _BadRequest(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _head(code: int, content_type: str, length: int | None = None,
          extra: dict | None = None) -> bytes:
    lines = [f"HTTP/1.1 {code} {HTTPStatus(code).phrase}",
             f"Content-Type: {content_type}"]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    lines += [f"{k}: {v}" for k, v in (extra or {}).items()]
    lines += ["Connection: close", "", ""]
    return "\r\n".join(lines).encode("latin-1")


async def _read_request(reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter
                        ) -> tuple[str, str, bytes]:
    """(method, path, body) of one request; ``_BadRequest`` if malformed."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.LimitOverrunError:
        raise _BadRequest(431, "request head too large") from None
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, _version = lines[0].split(" ", 2)
        headers = {}
        for line in lines[1:]:
            if line:
                name, value = line.split(":", 1)
                headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise _BadRequest(400, "malformed request head") from None
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise _BadRequest(411, "send the body with a Content-Length")
    if not 0 <= length <= MAX_BODY_BYTES:
        raise _BadRequest(413, f"body of {length} bytes is over the "
                               f"{MAX_BODY_BYTES}-byte limit")
    if length and headers.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
    body = await reader.readexactly(length)
    return method.upper(), target.split("?", 1)[0], body


async def _until_eof(reader: asyncio.StreamReader) -> None:
    """Return when the client's side of the connection is closed."""
    with contextlib.suppress(ConnectionError):
        while await reader.read(1 << 16):
            pass


class _Exchange:
    """One request/response on one connection: where the handler writes,
    and the context of the request it started, if any."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.ctx: Context | None = None
        self.streaming = False  # the 200 head of a stream is out

    async def send_json(self, code: int, payload: dict,
                        extra: dict | None = None) -> None:
        body = json.dumps(payload).encode()
        self.writer.write(_head(code, JSON_TYPE, len(body), extra) + body)
        await self.writer.drain()


class HttpService:
    def __init__(self, manager: ModelManager, host: str = "127.0.0.1",
                 port: int = 8000):
        self.manager = manager
        self.host, self.port = host, port
        self._server: asyncio.Server | None = None
        self._connections: set[asyncio.Task] = set()
        self._routes = {
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completion,
            ("GET", "/v1/models"): self._models,
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._live,
        }

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(self._connection,
                                                  self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("OpenAI HTTP service on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for task in list(self._connections):
            task.cancel()
        await asyncio.gather(*self._connections, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    # -- connections ----------------------------------------------------------
    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        ex = _Exchange(writer)
        try:
            try:
                method, path, body = await asyncio.wait_for(
                    _read_request(reader, writer), READ_TIMEOUT_S)
            except _BadRequest as exc:
                await ex.send_json(*_error_body(str(exc), code=exc.code))
                return
            except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                    ConnectionError):
                return
            route = self._routes.get((method, path))
            if route is None:
                await ex.send_json(*_error_body(
                    f"no route {method} {path}", "not_found", 404))
                return
            handler = asyncio.ensure_future(route(body, ex))
            gone = asyncio.ensure_future(_until_eof(reader))
            try:
                await asyncio.wait({handler, gone},
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                if not handler.done():
                    # The client went away (or the service stops): kill the
                    # request so the engine frees its slot.
                    if ex.ctx is not None:
                        ex.ctx.kill()
                    handler.cancel()
                gone.cancel()
                await asyncio.gather(handler, gone, return_exceptions=True)
            if not handler.cancelled() and handler.exception() is not None:
                exc = handler.exception()
                if not isinstance(exc, ConnectionError):
                    log.error("%s %s failed", method, path, exc_info=exc)
        finally:
            writer.close()
            self._connections.discard(task)

    async def _sse_stream(self, ex: _Exchange,
                          chunks: AsyncIterator[dict]) -> None:
        # Pull the first chunk BEFORE sending headers so pipeline errors
        # still surface as proper HTTP statuses.
        aiter = chunks.__aiter__()
        try:
            first_chunk = await aiter.__anext__()
        except StopAsyncIteration:
            first_chunk = None
        ex.writer.write(_head(200, "text/event-stream",
                              extra={"Cache-Control": "no-cache"}))
        ex.streaming = True
        try:
            if first_chunk is not None:
                ex.writer.write(
                    b"data: " + json.dumps(first_chunk).encode() + b"\n\n")
                await ex.writer.drain()
            async for chunk in aiter:
                ex.writer.write(
                    b"data: " + json.dumps(chunk).encode() + b"\n\n")
                await ex.writer.drain()
            ex.writer.write(b"data: [DONE]\n\n")
            await ex.writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            # Client went away: propagate kill so the engine frees the slot.
            ex.ctx.kill()
            raise

    # -- routes ---------------------------------------------------------------
    async def _pipeline(self, body: bytes, ex: _Exchange, cls,
                        run: Callable) -> None:
        """Validate a ``cls`` body, find its model, and answer with what
        ``run(request, served, exchange)`` returns (None once it streamed)
        or with the error status of what it raises."""
        try:
            req = cls.model_validate(json.loads(body))
        except ValueError as exc:  # JSON, UTF-8 or RequestValidationError
            await ex.send_json(*_error_body(str(exc)))
            return
        served = self.manager.get(req.model)
        if served is None:
            await ex.send_json(*_error_body(
                f"model {req.model!r} not found", "model_not_found", 404))
            return
        ex.ctx = Context()
        extra = None
        try:
            payload = await run(req, served, ex)
        except ConnectionError:
            raise
        except (NoInstancesError, OverloadedError) as exc:
            if ex.streaming:
                raise
            # The reference's Retry-After with no overload limiter (nor a
            # hint on the error): its default of one second.
            kind = ("overloaded" if isinstance(exc, OverloadedError)
                    else "service_unavailable")
            code, payload = _error_body(str(exc), kind, 503)
            extra = {"Retry-After": "1"}
        except AdapterNotFoundError as exc:
            # The model name resolved to an adapter card whose worker does
            # not hold the adapter: a naming error, 404 like an unknown
            # model, typed so clients can tell which.
            if ex.streaming:
                raise
            code, payload = _error_body(str(exc), "adapter_not_found", 404)
        except (ValueError, InvalidRequestError) as exc:
            if ex.streaming:
                raise
            code, payload = _error_body(str(exc))
        except Exception as exc:  # noqa: BLE001 — the 500 path
            if ex.streaming:
                raise
            log.exception("%s failed", cls.__name__)
            code, payload = _error_body(f"internal error: {exc}",
                                        "internal_error", 500)
        else:
            if payload is None:
                return
            code = 200
        await ex.send_json(code, payload, extra)

    async def _chat(self, body: bytes, ex: _Exchange) -> None:
        await self._pipeline(body, ex, ChatCompletionRequest, self._run_chat)

    async def _run_chat(self, req: ChatCompletionRequest, served,
                        ex: _Exchange) -> dict | None:
        chunks = served.preprocessor.generate(req, ex.ctx)
        if req.stream:
            await self._sse_stream(ex, chunks)
            return None
        # Non-streaming: force the usage chunk through the delta stream so
        # the aggregate carries real token counts.
        req.stream_options = {"include_usage": True}
        return await aggregate_chat_stream(chunks, 0)

    async def _completion(self, body: bytes, ex: _Exchange) -> None:
        await self._pipeline(body, ex, CompletionRequest,
                             self._run_completion)

    async def _run_completion(self, req: CompletionRequest, served,
                              ex: _Exchange) -> dict | None:
        if not req.stream:
            # Force the usage chunk so the folded response has counts.
            req.stream_options = {"include_usage": True}
        chunks = served.preprocessor.generate_completion(req, ex.ctx)
        if req.stream:
            await self._sse_stream(ex, chunks)
            return None
        texts: list[str] = []
        finish = None
        meta: dict = {}
        usage = None
        async for chunk in chunks:
            meta = {k: chunk.get(k, meta.get(k)) for k in ("id", "created")}
            if chunk.get("usage"):
                usage = chunk["usage"]
            for choice in chunk.get("choices", []):
                texts.append(choice.get("text") or "")
                finish = choice.get("finish_reason") or finish
        return {"id": meta.get("id"), "object": "text_completion",
                "created": meta.get("created"), "model": req.model,
                "choices": [{"index": 0, "text": "".join(texts),
                             "finish_reason": finish, "logprobs": None}],
                "usage": usage or usage_block(0, 0)}

    async def _models(self, _body: bytes, ex: _Exchange) -> None:
        await ex.send_json(200, {"object": "list",
                                 "data": self.manager.list_models()})

    async def _health(self, _body: bytes, ex: _Exchange) -> None:
        await ex.send_json(200, {"status": "healthy",
                                 "models": sorted(self.manager.models)})

    async def _live(self, _body: bytes, ex: _Exchange) -> None:
        await ex.send_json(200, {"status": "live"})
