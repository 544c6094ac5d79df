"""OpenAI-compatible HTTP front on the port's asyncio HTTP server (the
routes, bodies, error statuses, metrics and spans of
``dynamo_tpu.llm.http_service``, without aiohttp).

Routes: ``POST /v1/chat/completions``, ``POST /v1/completions`` and
``POST /v1/responses`` (streamed as server-sent events, or not),
``GET /v1/models``, ``GET /health``, ``GET /live``, ``GET /metrics``,
``POST /v1/embeddings``, ``POST /clear_kv_blocks``, ``GET /debug/fleet``
and the debug routes of ``runtime/health.add_debug_routes``.
``POST /v1/audio/transcriptions`` answers 501 naming ROADMAP item 15.
Errors are OpenAI error bodies: 400 for a body that does not
parse or validate and for ``ValueError`` / ``InvalidRequestError`` from
the pipeline, 404 for an unknown model, 404 ``adapter_not_found`` when a
model name resolves to a LoRA adapter its worker does not hold, 503
``service_unavailable`` when a routed model has no live worker
(``NoInstancesError``), 503 ``overloaded`` for capacity (the admission
queue full, every worker busy or circuit-open, a worker's TTFT
projection), 429 ``rate_limited`` for client pacing (a deadline the
admission projection cannot meet, batch traffic under brownout), 500
otherwise. Every 503 and 429 carries ``Retry-After``: the error's own
hint, else the limiter's queue-drain projection, else the overload
config's default, in whole seconds rounded up. A streamed response pulls
its first chunk before it sends headers, so pipeline errors keep their
status.

Overload defense (``overload``, an ``AdaptiveLimiter``; None turns it
off): each generate request is admitted through the limiter under its
``x-priority`` (interactive | batch) and ``x-request-deadline-ms``
headers (a malformed one is a 400), holds its permit until it ends and
reports its time to first chunk to it; under brownout ``max_tokens`` is
clamped and the response carries ``X-Overload-Brownout: <level>``. The
same first-chunk timing feeds the SLO plane's TTFT and ITL SLIs, and
each finished request its availability and goodput SLIs.

Each generate request runs under an ``http.request`` span, parented to an
incoming W3C ``traceparent`` header, whose ids ride the request plane to
the worker; it feeds the per-route series (``http_requests_total`` by
route and status, ``http_inflight``, ``http_request_duration_seconds``)
and, when streamed, ``ttft_seconds`` and ``itl_seconds`` by model, and it
leaves one accounting record in the ``RequestLedger``
(``/debug/requests``). ``tls_cert_path`` with ``tls_key_path`` serves
HTTPS; one without the other fails at ``start``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import ssl
import time
from typing import AsyncIterator

from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.preprocessor import aggregate_chat_stream
from dynamo_tpu_torch.llm.protocols import (ChatCompletionRequest,
                                            CompletionRequest, usage_block)
from dynamo_tpu_torch.llm.recorder import finish_account, make_account
from dynamo_tpu_torch.runtime import slo as slo_mod
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import (AdapterNotFoundError,
                                             InvalidRequestError,
                                             NoInstancesError,
                                             OverloadedError,
                                             RateLimitedError)
from dynamo_tpu_torch.runtime.health import add_debug_routes
from dynamo_tpu_torch.runtime.http_server import (Exchange, HttpServer,
                                                  Request, error_body)
from dynamo_tpu_torch.runtime.logging import (current_trace, get_logger,
                                              parse_traceparent)
from dynamo_tpu_torch.runtime.metrics import CONTENT_TYPE, MetricsRegistry
from dynamo_tpu_torch.runtime.overload import (PRIORITY_BATCH,
                                               PRIORITY_INTERACTIVE,
                                               AdaptiveLimiter)
from dynamo_tpu_torch.runtime.tracing import span

log = get_logger("http")

# Overload-defense request and response headers (the reference's).
DEADLINE_HEADER = "x-request-deadline-ms"
PRIORITY_HEADER = "x-priority"
BROWNOUT_HEADER = "X-Overload-Brownout"
# Accounting: multi-tenant attribution for /debug/requests.
TENANT_HEADER = "x-tenant"

NOT_PORTED_ROUTES = {
    "/v1/audio/transcriptions": "audio input is not ported: "
                                "/v1/audio/transcriptions waits for "
                                "ROADMAP item 15",
}


def _response_object(full: dict, model: str, text: str | None) -> dict:
    """OpenAI Responses-API response object from an aggregated chat
    result."""
    usage = full.get("usage") or {}
    return {
        "id": f"resp-{full.get('id')}",
        "object": "response",
        "created_at": full.get("created"),
        "model": model,
        "status": "completed",
        "output": [{
            "type": "message", "role": "assistant",
            "content": [{"type": "output_text", "text": text or ""}],
        }],
        "output_text": text or "",
        "usage": {
            "input_tokens": usage.get("prompt_tokens", 0),
            "output_tokens": usage.get("completion_tokens", 0),
            "total_tokens": usage.get("total_tokens", 0),
        },
    }


def _adapter_of(served) -> str | None:
    """The LoRA adapter a served model name resolves to (None: base)."""
    extra = served.entry.card.runtime_config.extra or {}
    return extra.get("adapter") if extra.get("lora_base") else None


def _retry_after_header(seconds: float) -> dict:
    """``Retry-After`` in whole seconds (RFC 9110), rounded up so 0.4 s
    does not tell clients to come straight back."""
    return {"Retry-After": str(max(1, int(-(-seconds // 1))))}


def _sse(payload: dict) -> bytes:
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


class _Outcome(Exception):
    """A finished request's status, raised out of a route body."""

    def __init__(self, code: int, payload: dict | None = None,
                 extra: dict | None = None):
        super().__init__(code)
        self.code, self.payload, self.extra = code, payload, extra


class HttpService:
    def __init__(self, manager: ModelManager, host: str = "127.0.0.1",
                 port: int = 8000, runtime=None,
                 metrics: MetricsRegistry | None = None,
                 tls_cert_path: str | None = None,
                 tls_key_path: str | None = None,
                 overload: AdaptiveLimiter | None = None):
        """``runtime`` (a DistributedRuntime) gives the metrics root, the
        discovery plane of ``/debug/fleet`` and the overload config's
        Retry-After default; without one, ``metrics`` (or a fresh
        registry) is the root and ``/debug/fleet`` answers 503.
        ``overload`` admits the generate routes (None: no admission
        control)."""
        self.manager = manager
        self.host, self.port = host, port
        self._runtime = runtime
        self.metrics = (metrics if metrics is not None
                        else runtime.metrics if runtime is not None
                        else MetricsRegistry())
        self.tls_cert_path = tls_cert_path
        self.tls_key_path = tls_key_path
        self.overload = overload
        # GET /debug/timeline provider: the frontend installs its
        # TimelineCollector's merged view before start(); left None, the
        # route serves this process's own journal.
        self.timeline_provider = None
        self._server: HttpServer | None = None
        m = self.metrics.namespace("http")
        self._m_requests = m.counter(
            "http_requests_total", "HTTP requests", ["route", "status"])
        self._m_inflight = m.gauge(
            "http_inflight", "In-flight HTTP requests", ["route"])
        self._m_ttft = m.histogram(
            "ttft_seconds", "Time to first token", ["model"],
            buckets=[.01, .025, .05, .1, .25, .5, 1, 2.5, 5, 10])
        self._m_itl = m.histogram(
            "itl_seconds", "Inter-token latency", ["model"],
            buckets=[.001, .0025, .005, .01, .025, .05, .1, .25, 1])
        self._m_duration = m.histogram(
            "http_request_duration_seconds", "Request duration", ["route"])

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        ssl_ctx = None
        if self.tls_cert_path or self.tls_key_path:
            if not (self.tls_cert_path and self.tls_key_path):
                raise ValueError(
                    "TLS needs BOTH tls_cert_path and tls_key_path")
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(self.tls_cert_path, self.tls_key_path)
        server = HttpServer(self.host, self.port, ssl_ctx)
        for method, path, handler in (
                ("POST", "/v1/chat/completions", self._chat),
                ("POST", "/v1/completions", self._completion),
                ("POST", "/v1/responses", self._responses),
                ("POST", "/v1/embeddings", self._embeddings),
                ("GET", "/v1/models", self._models),
                ("POST", "/clear_kv_blocks", self._clear_kv_blocks),
                ("GET", "/health", self._health),
                ("GET", "/live", self._live),
                ("GET", "/metrics", self._metrics),
                ("GET", "/debug/fleet", self._debug_fleet)):
            server.add(method, path, handler)
        for path, message in NOT_PORTED_ROUTES.items():
            server.add("POST", path, self._not_ported(message))
        add_debug_routes(server, kv_provider=self._kv_router_status,
                         perf_provider=self._perf_status,
                         timeline_provider=self.timeline_provider)
        await server.start()
        self._server = server
        self.port = server.port
        log.info("OpenAI %s service on %s:%d",
                 "HTTPS" if ssl_ctx else "HTTP", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None

    # -- the generate routes --------------------------------------------------
    async def _generate(self, req: Request, ex: Exchange, route: str,
                        parse, run) -> None:
        """One generate request: ``parse(body)`` gives the validated
        request (``ValueError`` -> 400), ``run(parsed, served, ctx, acct)``
        streams it (returning None) or returns the JSON body. Counts,
        spans and accounts it, and maps errors to statuses."""
        started = time.monotonic()
        self._m_inflight.inc(route=route)
        acct = None
        ctx = None
        code = None  # None: cancelled (the client went away)
        try:
            try:
                parsed = parse(req.json())
            except ValueError as exc:  # JSON, UTF-8 or validation
                raise _Outcome(*error_body(str(exc))) from None
            served = self.manager.get(parsed.model)
            if served is None:
                raise _Outcome(*error_body(
                    f"model {parsed.model!r} not found", "model_not_found",
                    404))
            acct = make_account(route, parsed.model)
            acct["adapter"] = _adapter_of(served)
            acct["tenant"] = req.headers.get(TENANT_HEADER)
            permit = await self._admit(req, ex, acct)
            ctx = self._make_context(req)
            ex.ctx = ctx
            ex.permit = permit
            acct["request_id"], acct["trace_id"] = ctx.id, ctx.trace_id
            try:
                with permit, span("http.request", ctx=ctx, route=route,
                                  model=parsed.model):
                    self._apply_brownout(parsed)
                    payload = await run(parsed, served, ex, acct)
            except ConnectionError:
                acct.update(status="cancelled", reason="client_disconnect")
                code = 500
                raise
            except Exception as exc:  # noqa: BLE001 — mapped below
                if ex.streaming:
                    # The 200 head is out: the stream just ends.
                    acct.update(status="error", reason=type(exc).__name__,
                                http_status=500)
                    code = 500
                    raise
                raise self._error_outcome(exc, acct) from None
            code = 200
            acct.update(status="ok", http_status=200)
            if payload is not None:
                await ex.send_json(200, payload)
        except _Outcome as out:
            code = out.code
            ex.headers = {}  # an error head carries no brownout level
            await ex.send_json(out.code, out.payload, out.extra)
        finally:
            if code is not None:
                self._m_requests.inc(route=route, status=str(code))
            self._account_done(acct, ctx)
            self._m_inflight.dec(route=route)
            self._m_duration.observe(time.monotonic() - started,
                                     route=route)

    def _retry_after(self, exc: Exception | None = None) -> float:
        """Retry-After seconds of a shed or overloaded answer: the error's
        own hint, else the limiter's admission-queue projection, else the
        overload config's default."""
        hint = getattr(exc, "retry_after_s", None)
        if hint:
            return hint
        if self.overload is not None:
            return self.overload.retry_after_s()
        if self._runtime is not None:
            return self._runtime.config.overload.retry_after_default_s
        return 1.0

    def _shed_outcome(self, exc: Exception, acct: dict) -> _Outcome:
        """The typed 429 (``RateLimitedError``) or 503 answer of a shed,
        with the limiter's reason in the accounting record."""
        if isinstance(exc, RateLimitedError):
            code, err_type, reason = 429, "rate_limited", "rate_limited"
        else:
            code, err_type, reason = 503, "overloaded", "overloaded"
        acct.update(status="shed", http_status=code,
                    reason=getattr(exc, "shed_reason", reason))
        return _Outcome(*error_body(str(exc), err_type, code),
                        _retry_after_header(self._retry_after(exc)))

    def _overload_params(self, req: Request):
        """(priority, deadline_ms) from the overload request headers; a
        malformed one is the caller's bug, a 400."""
        priority = req.headers.get(
            PRIORITY_HEADER, PRIORITY_INTERACTIVE).strip().lower()
        if priority not in (PRIORITY_INTERACTIVE, PRIORITY_BATCH):
            raise ValueError(f"unknown {PRIORITY_HEADER} {priority!r} "
                             f"(use 'interactive' or 'batch')")
        raw = req.headers.get(DEADLINE_HEADER)
        deadline_ms = None
        if raw is not None:
            try:
                deadline_ms = float(raw)
                if deadline_ms <= 0:
                    raise ValueError
            except ValueError:
                raise ValueError(f"invalid {DEADLINE_HEADER} {raw!r} "
                                 "(positive milliseconds)") from None
        return priority, deadline_ms

    async def _admit(self, req: Request, ex: Exchange, acct: dict):
        """The overload defense's admission of one request: its permit
        (a null context without a limiter), or an ``_Outcome`` raised with
        the typed 400, 429 or 503. The record picks up the priority, the
        deadline, the admission wait and, on a shed, the limiter's
        reason; the exchange, the brownout header."""
        if self.overload is None:
            return contextlib.nullcontext()
        try:
            priority, deadline_ms = self._overload_params(req)
        except ValueError as exc:
            acct.update(status="error", reason="bad_overload_header",
                        http_status=400)
            raise _Outcome(*error_body(str(exc))) from None
        acct["priority"] = priority
        acct["deadline_ms"] = deadline_ms
        t0 = time.monotonic()
        try:
            permit = await self.overload.admit(priority, deadline_ms)
        except (RateLimitedError, OverloadedError) as exc:
            raise self._shed_outcome(exc, acct) from None
        acct["queue_wait_s"] = time.monotonic() - t0
        level = self.overload.pressure_level()
        acct["brownout_level"] = level
        if level > 0:
            # Clients see (and can log) that they got degraded service.
            ex.headers[BROWNOUT_HEADER] = str(level)
        return permit

    def _apply_brownout(self, parsed) -> None:
        """Brownout's degradation hook: clamp max_tokens (the clamped
        value shows in the usage block)."""
        if self.overload is None:
            return
        clamped = self.overload.clamp_max_tokens(
            getattr(parsed, "max_tokens", None))
        if clamped is not None:
            parsed.max_tokens = clamped

    def _error_outcome(self, exc: Exception, acct: dict) -> _Outcome:
        if isinstance(exc, NoInstancesError):
            acct.update(status="shed", reason="no_instances",
                        http_status=503)
            return _Outcome(*error_body(str(exc), "service_unavailable",
                                        503),
                            _retry_after_header(self._retry_after(exc)))
        if isinstance(exc, (RateLimitedError, OverloadedError)):
            return self._shed_outcome(exc, acct)
        if isinstance(exc, AdapterNotFoundError):
            # A naming error, 404 like an unknown model, typed so clients
            # can tell which.
            acct.update(status="error", reason="adapter_not_found",
                        http_status=404)
            return _Outcome(*error_body(str(exc), "adapter_not_found", 404))
        if isinstance(exc, (ValueError, InvalidRequestError)):
            acct.update(status="error", reason="invalid_request",
                        http_status=400)
            return _Outcome(*error_body(str(exc)))
        log.error("generate handler failed", exc_info=exc)
        acct.update(status="error", reason=type(exc).__name__,
                    http_status=500)
        return _Outcome(*error_body(f"internal error: {exc}",
                                    "internal_error", 500))

    def _make_context(self, req: Request) -> Context:
        header = req.headers.get("traceparent")
        trace = parse_traceparent(header) if header else None
        ctx = Context(trace_id=trace["trace_id"] if trace else None,
                      parent_span_id=trace["parent_id"] if trace else None)
        # Log lines of this handler task carry the request's trace.
        current_trace.set({"trace_id": ctx.trace_id, "span_id": ctx.span_id})
        return ctx

    @staticmethod
    def _account_done(acct: dict | None, ctx) -> None:
        """Finalize and ledger the record once; a record with no outcome
        is a client that went away. The SLO plane's availability and
        goodput SLIs take real outcomes only (a 400 is the caller's bug,
        no SLO event)."""
        if acct is None or "_t0" not in acct:
            return
        status = acct.get("status") or "cancelled"
        reason = acct.get("reason") or (
            "client_disconnect" if status == "cancelled" else None)
        http_status = acct.get("http_status")
        feed = status in ("ok", "shed") or (http_status or 0) >= 500
        finish_account(acct, status, reason, http_status, ctx=ctx,
                       slo_plane=slo_mod.get_plane() if feed else None)

    @staticmethod
    async def _timed(chunks: AsyncIterator[dict], ex: Exchange, acct: dict
                     ) -> AsyncIterator[dict]:
        """From one timing point: the permit's latency sample (the time to
        first chunk, which AIMD adapts against), the SLO plane's TTFT and
        ITL SLIs, and the accounting record's TTFT, inter-chunk gaps and
        usage counts."""
        plane = slo_mod.get_plane()
        permit = ex.permit
        started = time.monotonic()
        last_t = None
        async for chunk in chunks:
            now = time.monotonic()
            if last_t is None:
                ttft = now - started
                if hasattr(permit, "note_latency"):
                    permit.note_latency(ttft)
                plane.observe_ttft(ttft)
                acct["ttft_s"] = ttft
            else:
                plane.observe_itl(now - last_t)
                acct["_itls"].append(now - last_t)
            last_t = now
            usage = chunk.get("usage") if isinstance(chunk, dict) else None
            if usage:
                acct["prompt_tokens"] = usage.get("prompt_tokens")
                acct["output_tokens"] = usage.get("completion_tokens")
            yield chunk

    async def _sse_stream(self, ex: Exchange, chunks: AsyncIterator[dict],
                          model: str, frame=_sse) -> None:
        """Stream ``chunks`` as server-sent events, ``frame(chunk)`` each,
        then ``data: [DONE]``. The first chunk is pulled before the head
        goes out, so pipeline errors keep their status."""
        start_t = time.monotonic()
        aiter = chunks.__aiter__()
        try:
            first_chunk = await aiter.__anext__()
        except StopAsyncIteration:
            first_chunk = None
        self._m_ttft.observe(time.monotonic() - start_t, model=model)
        await ex.start_stream()
        last_t = time.monotonic()
        try:
            if first_chunk is not None:
                await ex.write(frame(first_chunk))
            async for chunk in aiter:
                now = time.monotonic()
                self._m_itl.observe(now - last_t, model=model)
                last_t = now
                await ex.write(frame(chunk))
            await ex.write(b"data: [DONE]\n\n")
        except (ConnectionError, asyncio.CancelledError):
            # The client went away: kill the request so the engine frees
            # the slot.
            ex.ctx.kill()
            raise

    async def _chat(self, req: Request, ex: Exchange) -> None:
        await self._generate(req, ex, "chat_completions",
                             ChatCompletionRequest.model_validate,
                             self._run_chat)

    async def _run_chat(self, chat: ChatCompletionRequest, served,
                        ex: Exchange, acct: dict) -> dict | None:
        chunks = self._timed(served.preprocessor.generate(chat, ex.ctx),
                             ex, acct)
        if chat.stream:
            await self._sse_stream(ex, chunks, chat.model)
            return None
        # Non-streaming: force the usage chunk through the delta stream so
        # the aggregate carries real token counts.
        chat.stream_options = {"include_usage": True}
        return await aggregate_chat_stream(chunks, 0)

    async def _completion(self, req: Request, ex: Exchange) -> None:
        await self._generate(req, ex, "completions",
                             CompletionRequest.model_validate,
                             self._run_completion)

    async def _run_completion(self, comp: CompletionRequest, served,
                              ex: Exchange, acct: dict) -> dict | None:
        if not comp.stream:
            # Force the usage chunk so the folded response has counts.
            comp.stream_options = {"include_usage": True}
        chunks = self._timed(
            served.preprocessor.generate_completion(comp, ex.ctx), ex, acct)
        if comp.stream:
            await self._sse_stream(ex, chunks, comp.model)
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
                "created": meta.get("created"), "model": comp.model,
                "choices": [{"index": 0, "text": "".join(texts),
                             "finish_reason": finish, "logprobs": None}],
                "usage": usage or usage_block(0, 0)}

    async def _responses(self, req: Request, ex: Exchange) -> None:
        """OpenAI /v1/responses over the chat pipeline."""
        await self._generate(req, ex, "responses", self._parse_responses,
                             self._run_responses)

    @staticmethod
    def _parse_responses(body) -> ChatCompletionRequest:
        if not isinstance(body, dict) or "model" not in body:
            raise ValueError("'model' is required")
        raw_input = body.get("input", "")
        if isinstance(raw_input, str):
            messages = [{"role": "user", "content": raw_input}]
        else:
            messages = [{"role": m.get("role", "user"),
                         "content": m.get("content", "")}
                        for m in raw_input]
        if body.get("instructions"):
            messages.insert(0, {"role": "system",
                                "content": body["instructions"]})
        fields = {"model": body["model"], "messages": messages,
                  "stream": bool(body.get("stream")),
                  "stream_options": {"include_usage": True}}
        for key, name in (("max_output_tokens", "max_tokens"),
                          ("temperature", "temperature"),
                          ("top_p", "top_p")):
            if body.get(key) is not None:
                fields[name] = body[key]
        return ChatCompletionRequest.model_validate(fields)

    async def _run_responses(self, chat: ChatCompletionRequest, served,
                             ex: Exchange, acct: dict) -> dict | None:
        chunks = self._timed(served.preprocessor.generate(chat, ex.ctx),
                             ex, acct)
        if chat.stream:
            await self._responses_sse(ex, chunks, chat.model)
            return None
        full = await aggregate_chat_stream(chunks, 0)
        msg = full["choices"][0]["message"]
        return _response_object(full, chat.model, msg.get("content"))

    async def _responses_sse(self, ex: Exchange, chunks, model: str) -> None:
        """Responses-API streaming: a ``response.output_text.delta`` event
        per content delta, then ``response.completed`` with the final
        object. The first chunk is pulled before the head goes out."""
        aiter = chunks.__aiter__()
        try:
            first = await aiter.__anext__()
        except StopAsyncIteration:
            first = None
        await ex.start_stream()

        async def send(event: str, data: dict) -> None:
            await ex.write(
                f"event: {event}\ndata: {json.dumps(data)}\n\n".encode())

        content: list[str] = []
        meta: dict = {}
        usage: dict = {}

        async def rest():
            if first is not None:
                yield first
            async for chunk in aiter:
                yield chunk

        try:
            async for chunk in rest():
                meta = {k: chunk.get(k, meta.get(k))
                        for k in ("id", "created")}
                if chunk.get("usage"):
                    usage = chunk["usage"]
                for choice in chunk.get("choices", []):
                    piece = (choice.get("delta") or {}).get("content")
                    if piece:
                        content.append(piece)
                        await send("response.output_text.delta",
                                   {"delta": piece})
            full = {"id": meta.get("id"), "created": meta.get("created"),
                    "usage": usage}
            await send("response.completed",
                       {"response": _response_object(full, model,
                                                     "".join(content))})
        except (ConnectionError, asyncio.CancelledError):
            ex.ctx.kill()
            raise

    # -- the other routes -----------------------------------------------------
    async def _embeddings(self, req: Request, ex: Exchange) -> None:
        """OpenAI /v1/embeddings: tokenizes the input (a string, a list of
        strings, a token list or a list of token lists) and asks the
        in-process engine (static pipeline) or a worker (``{"embed":
        True, ...}`` round-robin) for the pooled, normalized vectors."""
        route = "embeddings"
        started = time.monotonic()
        self._m_inflight.inc(route=route)
        code, payload, extra = 500, None, None
        try:
            code, payload, extra = await self._embed_answer(req)
        except Exception as exc:  # noqa: BLE001
            log.exception("embeddings handler failed")
            code, payload = error_body(f"internal error: {exc}",
                                       "internal_error", 500)
        finally:
            self._m_requests.inc(route=route, status=str(code))
            self._m_inflight.dec(route=route)
            self._m_duration.observe(time.monotonic() - started, route=route)
        await ex.send_json(code, payload, extra)

    async def _embed_answer(self, req: Request
                            ) -> tuple[int, dict, dict | None]:
        """(status, body, extra headers) of one /v1/embeddings request."""
        try:
            body = req.json()
            model = body["model"]
            raw = body.get("input")
            if raw is None:
                raise ValueError("missing 'input'")
        except (KeyError, ValueError) as exc:
            return (*error_body(str(exc)), None)
        served = self.manager.get(model)
        if served is None:
            return (*error_body(f"model {model!r} not found",
                                "model_not_found", 404), None)
        inputs = raw if isinstance(raw, list) else [raw]
        if inputs and isinstance(inputs[0], int):
            inputs = [inputs]  # one pre-tokenized prompt
        tokenizer = served.preprocessor.tokenizer
        token_lists = [t if isinstance(t, list) else tokenizer.encode(t)
                       for t in inputs]
        limit = served.entry.card.context_length
        if not token_lists or any(not t for t in token_lists):
            return (*error_body("'input' must contain at least one "
                                "non-empty prompt"), None)
        if any(len(t) > limit for t in token_lists):
            return (*error_body(f"input exceeds the model context length "
                                f"({limit})"), None)
        pooling = body.get("pooling", "last")
        try:
            if served.client is None:
                # Static pipeline (the launcher): the in-process engine
                # behind Preprocessor -> Backend.
                vectors = await served.preprocessor.inner.inner.embed(
                    token_lists, pooling)
            else:
                stream = await served.client.generate(
                    {"embed": True, "token_lists": token_lists,
                     "pooling": pooling}, mode="round_robin")
                vectors = None
                async for item in stream:
                    if "embeddings" in item:
                        vectors = item["embeddings"]
                if vectors is None:
                    raise RuntimeError("worker returned no embeddings")
        except NoInstancesError as exc:
            return (*error_body(str(exc), "service_unavailable", 503),
                    _retry_after_header(self._retry_after(exc)))
        total = sum(len(t) for t in token_lists)
        return 200, {
            "object": "list", "model": model,
            "data": [{"object": "embedding", "index": i, "embedding": v}
                     for i, v in enumerate(vectors)],
            "usage": {"prompt_tokens": total, "total_tokens": total},
        }, None

    @staticmethod
    def _not_ported(message: str):
        async def handler(_req: Request, ex: Exchange) -> None:
            await ex.send_json(*error_body(message, "not_implemented", 501))
        return handler

    async def _clear_kv_blocks(self, _req: Request, ex: Exchange) -> None:
        """Tell every worker of every served model to drop its reusable
        prefix cache."""
        results: dict[str, dict] = {}
        for name, served in self.manager.models.items():
            per_model: dict[str, int] = {}
            if served.client is None:
                engine = getattr(getattr(served.preprocessor, "inner",
                                         None), "inner", None)
                clear = getattr(engine, "clear_kv_blocks", None)
                if clear is not None:
                    per_model["local"] = await clear()
            else:
                for iid in served.client.instance_ids():
                    try:
                        stream = await served.client.generate(
                            {"clear_kv_blocks": True}, instance_id=iid)
                        async for item in stream:
                            if "cleared" in item:
                                per_model[f"{iid:x}"] = item["cleared"]
                    except Exception as exc:  # noqa: BLE001 — per worker
                        per_model[f"{iid:x}"] = -1
                        log.warning("clear_kv_blocks failed on %x: %s",
                                    iid, exc)
            results[name] = per_model
        await ex.send_json(200, {"cleared": results})

    def _kv_router_status(self) -> dict:
        """This front's /debug/kv: each model's KV router view, and the
        KV state of in-process engines (the one-process launcher)."""
        routers = {}
        engines = {}
        for name, served in self.manager.models.items():
            status = getattr(served.router, "kv_status", None)
            if status is not None:
                routers[name] = status()
            if served.client is None:
                engine = getattr(getattr(served.preprocessor, "inner",
                                         None), "inner", None)
                engine_status = getattr(engine, "kv_status", None)
                if engine_status is not None:
                    engines[name] = engine_status()
        return {"role": "frontend", "routers": routers, "engines": engines}

    def _perf_status(self) -> dict:
        """This front's /debug/perf: the process-global registry plus the
        full perf view of each in-process engine (the one-process
        launcher has no worker status server to ask)."""
        from dynamo_tpu_torch.engine.perf import process_perf_status
        engines = {}
        for name, served in self.manager.models.items():
            if served.client is not None:
                continue
            engine = getattr(getattr(served.preprocessor, "inner", None),
                             "inner", None)
            status = getattr(engine, "perf_status", None)
            if status is not None:
                engines[name] = status()
        body = process_perf_status()
        body["role"] = "frontend"
        body["engines"] = engines
        return body

    async def _debug_fleet(self, req: Request, ex: Exchange) -> None:
        """Every registered worker status server's KV view, merged."""
        from dynamo_tpu_torch.llm.fleet import (DEFAULT_CONCURRENCY,
                                                DEFAULT_TIMEOUT_S,
                                                fleet_kv_snapshot)
        if self._runtime is None:
            await ex.send_json(503, {
                "error": "static runtime: no discovery plane to enumerate "
                         "worker status servers"})
            return
        try:
            timeout_s = float(req.query.get("timeout_s", DEFAULT_TIMEOUT_S))
            concurrency = int(req.query.get("concurrency",
                                            DEFAULT_CONCURRENCY))
        except ValueError:
            await ex.send_json(*error_body(
                "timeout_s/concurrency must be numeric"))
            return
        snapshot = await fleet_kv_snapshot(
            self._runtime, timeout_s=timeout_s, concurrency=concurrency,
            router_view=self._kv_router_status)
        await ex.send_json(200, snapshot)

    async def _models(self, _req: Request, ex: Exchange) -> None:
        await ex.send_json(200, {"object": "list",
                                 "data": self.manager.list_models()})

    async def _health(self, _req: Request, ex: Exchange) -> None:
        await ex.send_json(200, {"status": "healthy",
                                 "models": sorted(self.manager.models)})

    async def _live(self, _req: Request, ex: Exchange) -> None:
        await ex.send_json(200, {"status": "live"})

    async def _metrics(self, _req: Request, ex: Exchange) -> None:
        await ex.send(200, CONTENT_TYPE, self.metrics.expose())
