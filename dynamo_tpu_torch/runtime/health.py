"""System status server and the debug API (the routes, bodies and
statuses of ``dynamo_tpu.runtime.health``, on the port's asyncio HTTP
server instead of aiohttp).

``SystemStatusServer`` is the per-worker HTTP server of
``DTPU_SYSTEM_ENABLED=1`` (port ``DTPU_SYSTEM_PORT``, 0 picks one):
``/health``, ``/live``, ``/metrics`` and the debug routes that
``add_debug_routes`` also puts on the OpenAI front:

- ``GET /debug/traces/recent``            newest-first trace index
- ``GET /debug/traces?trace_id=&format=`` one trace (chrome|otlp|spans)
- ``POST /debug/profile``                 ``torch.profiler`` capture
  (``{"duration_ms": 1000, "out_dir": ...}``); 409 while one runs. A
  worker whose engine runs on the card records CUDA activity and answers
  500 with the reason when the profiler fails; a frontend records CPU
  activity only
- ``GET /debug/requests?limit=``          per-request accounting records
- ``GET /debug/flight``                   flight-recorder ring and meta;
  ``POST /debug/flight`` writes a diagnostic bundle
- ``GET /debug/kv``                       this process's KV view (a
  worker's ``GPUEngine.kv_status``, a KV-mode front's router view)
- ``GET /debug/timeline``                 the merged fleet timeline on a
  frontend, this process's journal elsewhere
- ``GET /debug/slo``                      SLO targets, windowed SLIs, burn
  rates, alert states and pressure (``runtime/slo.py``)
- ``GET /debug/perf``                     the engine perf plane: window
  captures per program family, the window/roofline series, device memory
  and the memory breakdown (a worker's ``GPUEngine.perf_status``, a
  front's merged engines); without a provider the process-global
  registry (``engine/perf.py``'s ``process_perf_status``)

A worker's server also carries the control verbs, as the reference's:

- ``GET /control/role``   the role manager's status (``llm/reconfig.py``)
- ``POST /control/role``  ``{"role": "prefill", "epoch": 7, "drain_s"?}``:
  a SetRole flip, fenced as a directive is (409 with the typed error on
  a stale epoch or a flip in flight; the epoch is required, so a
  replayed call cannot flip again)
- ``GET /control/scale``  the scale agent's standby status
  (``llm/standby.py``)
- ``POST /control/scale`` ``{"action": "promote"|"retire", "epoch": N,
  "role"?}``: the scale directive's verb, fenced the same way

A process without a role manager (or scale agent) answers 404 there.
"""

from __future__ import annotations

import asyncio
import json
import tempfile
from typing import Callable

from dynamo_tpu_torch.runtime import flight, journal, slo, tracing
from dynamo_tpu_torch.runtime.errors import RoleTransitionError
from dynamo_tpu_torch.runtime.http_server import (Exchange, HttpServer,
                                                  Request)
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.metrics import CONTENT_TYPE

log = get_logger("health")


def _body_json(req: Request, strict: bool = False) -> dict | None:
    """The request's JSON object; when the body is not one, an empty dict,
    or None with ``strict`` (the control verbs answer 400 then, as the
    reference's do)."""
    try:
        body = req.json()
    except ValueError:
        body = None
    if isinstance(body, dict):
        return body
    return None if strict else {}


def add_debug_routes(server: HttpServer,
                     kv_provider: Callable[[], dict] | None = None,
                     timeline_provider: Callable[[int], dict] | None = None,
                     before_block=None, cuda: bool = False,
                     perf_provider: Callable[[], dict] | None = None) -> None:
    """Put the debug routes on ``server``. ``kv_provider`` answers
    ``/debug/kv`` and ``perf_provider`` ``/debug/perf``;
    ``timeline_provider(limit)`` answers
    ``/debug/timeline`` (a frontend's merged fleet timeline);
    ``before_block`` and ``cuda`` go to ``capture_profile`` (a worker
    renews its lease with the first, and a worker whose engine runs on
    the card asks for CUDA activity)."""

    async def debug_profile(req: Request, ex: Exchange) -> None:
        await _debug_profile(req, ex, before_block, cuda)

    async def debug_timeline(req: Request, ex: Exchange) -> None:
        try:
            limit = int(req.query.get("limit", "512"))
        except ValueError:
            await ex.send_json(400, {"error": "limit must be an integer"})
            return
        if timeline_provider is None:
            await ex.send_json(200, {"role": "process",
                                     **journal.get_journal().snapshot(limit)})
            return
        try:
            body = timeline_provider(limit)
        except Exception as exc:  # noqa: BLE001 — a pane, not a crash
            log.exception("timeline provider failed")
            await ex.send_json(
                500, {"error": f"timeline provider failed: {exc}"})
            return
        await ex.send_json(200, body)

    async def debug_kv(_req: Request, ex: Exchange) -> None:
        if kv_provider is None:
            await ex.send_json(404, {
                "error": "no KV status provider on this process (a worker "
                         "registers its engine, a KV-mode frontend its "
                         "router)"})
            return
        try:
            body = kv_provider()
        except Exception as exc:  # noqa: BLE001 — a pane, not a crash
            log.exception("kv status provider failed")
            await ex.send_json(500, {"error": f"kv provider failed: {exc}"})
            return
        await ex.send_json(200, body)

    async def debug_perf(_req: Request, ex: Exchange) -> None:
        provider = perf_provider
        if provider is None:
            # The registry is process-global: a process without an engine
            # still reports what it knows.
            from dynamo_tpu_torch.engine.perf import process_perf_status
            provider = process_perf_status
        try:
            body = provider()
        except Exception as exc:  # noqa: BLE001 — a pane, not a crash
            log.exception("perf status provider failed")
            await ex.send_json(500, {"error": f"perf provider failed: {exc}"})
            return
        await ex.send_json(200, body)

    for method, path, handler in (
            ("GET", "/debug/traces", _debug_traces),
            ("GET", "/debug/traces/recent", _debug_traces_recent),
            ("POST", "/debug/profile", debug_profile),
            ("GET", "/debug/slo", _debug_slo),
            ("GET", "/debug/requests", _debug_requests),
            ("GET", "/debug/flight", _debug_flight),
            ("POST", "/debug/flight", _debug_flight_capture),
            ("GET", "/debug/kv", debug_kv),
            ("GET", "/debug/perf", debug_perf),
            ("GET", "/debug/timeline", debug_timeline)):
        server.add(method, path, handler)


async def _debug_slo(_req: Request, ex: Exchange) -> None:
    await ex.send_json(200, slo.get_plane().snapshot())


async def _debug_requests(req: Request, ex: Exchange) -> None:
    from dynamo_tpu_torch.llm.recorder import get_ledger
    limit = int(req.query.get("limit", "100"))
    await ex.send_json(200, get_ledger().snapshot(limit))


async def _debug_flight(_req: Request, ex: Exchange) -> None:
    rec = flight.get_recorder()
    await ex.send_json(200, {"meta": rec.meta(), "windows": rec.dump(),
                             "triggers_total": flight.triggers_total})


async def _debug_flight_capture(req: Request, ex: Exchange) -> None:
    body = _body_json(req)
    reason = str(body.get("reason", "manual"))
    # The bundle serializes the ring and the span recorder: off the loop.
    path = await asyncio.to_thread(flight.capture_bundle, reason,
                                   body.get("out_dir"))
    await ex.send_json(200, {"bundle": path, "reason": reason})


async def _debug_traces_recent(req: Request, ex: Exchange) -> None:
    limit = int(req.query.get("limit", "50"))
    await ex.send_json(200, tracing.traces_index(limit=limit))


async def _debug_traces(req: Request, ex: Exchange) -> None:
    trace_id = req.query.get("trace_id")
    if not trace_id:
        await _debug_traces_recent(req, ex)
        return
    try:
        payload = tracing.trace_payload(trace_id,
                                        req.query.get("format", "chrome"))
    except ValueError as exc:
        await ex.send_json(400, {"error": str(exc)})
        return
    if payload is None:
        await ex.send_json(404, {
            "error": f"trace {trace_id!r} not found (evicted or never "
                     "recorded; recorder enabled="
                     f"{tracing.get_recorder().enabled})"})
        return
    await ex.send_json(200, payload)


async def _debug_profile(req: Request, ex: Exchange, before_block,
                         cuda: bool) -> None:
    body = _body_json(req)
    duration_ms = int(body.get("duration_ms", 1000))
    out_dir = body.get("out_dir") or tempfile.mkdtemp(prefix="dtpu-profile-")
    try:
        result = await tracing.capture_profile(duration_ms, out_dir,
                                               before_block=before_block,
                                               cuda=cuda)
    except tracing.ProfileBusyError as exc:
        await ex.send_json(409, {"error": str(exc)})
        return
    except tracing.ProfileError as exc:
        log.error("profile capture failed: %s", exc)
        await ex.send_json(500, {"error": str(exc)})
        return
    log.info("profile captured: %s", {k: v for k, v in result.items()
                                      if k != "kernels"})
    await ex.send_json(200, result)


class SystemStatusServer:
    def __init__(self, runtime, host: str = "0.0.0.0", port: int = 0,
                 kv_provider: Callable[[], dict] | None = None,
                 cuda: bool = False,
                 perf_provider: Callable[[], dict] | None = None,
                 role_manager=None, scale_agent=None):
        self._runtime = runtime
        self.host, self.port = host, port
        # /debug/profile records CUDA activity: the worker's engine runs
        # on the card.
        self.cuda = cuda
        self._endpoint_health: dict[str, bool] = {}
        # /debug/kv provider for THIS worker (engine.kv_status).
        self.kv_provider = kv_provider
        # /debug/perf provider for THIS worker (engine.perf_status).
        self.perf_provider = perf_provider
        # llm/reconfig.RoleManager: the SetRole verb (/control/role).
        self.role_manager = role_manager
        # llm/standby.ScaleAgent: the scale verb (/control/scale).
        self.scale_agent = scale_agent
        self._server: HttpServer | None = None

    def set_endpoint_health(self, endpoint_path: str, healthy: bool) -> None:
        self._endpoint_health[endpoint_path] = healthy

    async def start(self) -> None:
        server = HttpServer(self.host, self.port)
        server.add("GET", "/health", self._health)
        server.add("GET", "/live", self._live)
        server.add("GET", "/metrics", self._metrics)
        server.add("GET", "/control/role", self._role_status)
        server.add("POST", "/control/role", self._role_set)
        server.add("GET", "/control/scale", self._scale_status)
        server.add("POST", "/control/scale", self._scale_apply)
        add_debug_routes(server, kv_provider=self.kv_provider,
                         before_block=self._renew_lease, cuda=self.cuda,
                         perf_provider=self.perf_provider)
        await server.start()
        self._server = server
        self.port = server.port
        log.info("system status server on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None

    async def _renew_lease(self) -> None:
        await self._runtime.require_coordinator().renew_lease()

    async def _health(self, _req: Request, ex: Exchange) -> None:
        healthy = (all(self._endpoint_health.values())
                   if self._endpoint_health else True)
        body = {"status": "healthy" if healthy else "unhealthy",
                "endpoints": self._endpoint_health}
        await ex.send(200 if healthy else 503, "application/json",
                      json.dumps(body).encode())

    async def _live(self, _req: Request, ex: Exchange) -> None:
        await ex.send(200, "application/json",
                      json.dumps({"status": "live"}).encode())

    async def _metrics(self, _req: Request, ex: Exchange) -> None:
        await ex.send(200, CONTENT_TYPE, self._runtime.metrics.expose())

    # -- the scale verb (llm/standby.py) -----------------------------------------
    async def _scale_status(self, _req: Request, ex: Exchange) -> None:
        if self.scale_agent is None:
            await ex.send_json(404, {"error": "no scale agent on this worker"})
            return
        await ex.send_json(200, self.scale_agent.standby_status())

    async def _scale_apply(self, req: Request, ex: Exchange) -> None:
        """POST /control/scale: the scale directive's verb from an
        operator, fenced as the coordinator directive is."""
        if self.scale_agent is None:
            await ex.send_json(404, {"error": "no scale agent on this worker"})
            return
        body = _body_json(req, strict=True)
        if body is None:
            await ex.send_json(400, {"error": "invalid JSON body"})
            return
        action, epoch = body.get("action"), body.get("epoch")
        if action not in ("promote", "retire") or not isinstance(epoch, int):
            await ex.send_json(400, {
                "error": "body must carry action:promote|retire and "
                         "epoch:int (above the applied epoch in "
                         "GET /control/scale)"})
            return
        directive = {**body, "issued_by": str(body.get("issued_by", "http"))}
        try:
            if action == "promote":
                await self.scale_agent._promote(directive)
            else:
                await self.scale_agent._retire(directive)
        except RoleTransitionError as exc:
            await ex.send_json(409, {"error": str(exc),
                                     "type": "role_transition"})
            return
        await ex.send_json(200, self.scale_agent.standby_status())

    # -- the SetRole verb (llm/reconfig.py) --------------------------------------
    async def _role_status(self, _req: Request, ex: Exchange) -> None:
        if self.role_manager is None:
            await ex.send_json(404, {"error": "no role manager on this worker"})
            return
        await ex.send_json(200, self.role_manager.status())

    async def _role_set(self, req: Request, ex: Exchange) -> None:
        """POST /control/role: a SetRole flip from an operator. The epoch
        is required, so a replayed call cannot flip again."""
        if self.role_manager is None:
            await ex.send_json(404, {"error": "no role manager on this worker"})
            return
        body = _body_json(req, strict=True)
        if body is None:
            await ex.send_json(400, {"error": "invalid JSON body"})
            return
        role, epoch = body.get("role"), body.get("epoch")
        if not isinstance(role, str) or not isinstance(epoch, int):
            await ex.send_json(400, {
                "error": "body must carry role:str and epoch:int (epoch "
                         "must be above the applied epoch in "
                         "GET /control/role)"})
            return
        try:
            outcome = await self.role_manager.set_role(
                role, epoch, issued_by=str(body.get("issued_by", "http")),
                drain_s=body.get("drain_s"))
        except RoleTransitionError as exc:
            await ex.send_json(409, {"error": str(exc),
                                     "type": "role_transition"})
            return
        await ex.send_json(200, outcome)
