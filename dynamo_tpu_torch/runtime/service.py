"""Endpoint server: the ingress half of the request plane (copy of
``dynamo_tpu.runtime.service.EndpointServer`` without its tracing span and
metrics counters).

A plain duplex framed-TCP server per endpoint instance: one connection
carries many concurrent request streams, multiplexed by request id
(``rid``). Frames in: ``req`` (``rid``, ``ctx``, payload ``p``), ``stop``
and ``kill``. Frames out: ``data`` (``p`` and the per-stream sequence
number ``s``), then ``final`` carrying the total, or ``err`` with one of
the tokens of ``runtime/errors.py``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.runtime.component import Endpoint, Instance
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import (INCOMPLETE, KILLED,
                                             AdapterNotFoundError,
                                             InvalidRequestError,
                                             OverloadedError)
from dynamo_tpu_torch.runtime.frame import read_frame, write_frame
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("service")


class EndpointServer:
    def __init__(self, runtime, endpoint: Endpoint,
                 handler: Callable[[Any, Context], AsyncIterator[Any]],
                 graceful_shutdown: bool = True):
        self._runtime = runtime
        self._endpoint = endpoint
        self._handler = handler
        self._graceful = graceful_shutdown
        self._server: asyncio.AbstractServer | None = None
        self._conn_writers: set[asyncio.StreamWriter] = set()
        self._inflight: dict[str, tuple[asyncio.Task, Context]] = {}
        self._stopping = asyncio.Event()
        self.instance: Instance | None = None

    async def start(self) -> None:
        cfg = self._runtime.config
        self._server = await asyncio.start_server(
            self._handle_conn, cfg.bind_host, 0)
        port = self._server.sockets[0].getsockname()[1]
        self.instance = Instance(
            namespace=self._endpoint.component.namespace,
            component=self._endpoint.component.name,
            endpoint=self._endpoint.name,
            instance_id=self._runtime.instance_id,
            host=self._runtime.advertise_host,
            port=port,
        )
        # Registration rides the primary lease: process death => lease
        # expiry => delete event => clients drop us.
        try:
            await self._register()
        except BaseException:
            self._server.close()
            raise
        self._runtime.coordinator_client.on_lease_recreated(
            self._on_lease_recreated)
        log.info("endpoint %s serving as instance %x on %s:%d",
                 self._endpoint.path, self.instance.instance_id,
                 self.instance.host, port)

    async def _register(self) -> None:
        await self._runtime.coordinator_client.kv_put(
            self.instance.path, self.instance.to_wire(),
            use_primary_lease=True)

    async def _on_lease_recreated(self, _new_lease_id: int) -> None:
        """The primary lease was lost and re-granted: register again so
        traffic does not silently drain away."""
        if not self._stopping.is_set():
            await self._register()

    @property
    def port(self) -> int:
        assert self.instance is not None
        return self.instance.port

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        send_lock = asyncio.Lock()

        async def send(obj: dict) -> None:
            async with send_lock:
                await write_frame(writer, obj)

        conn_rids: set[str] = set()  # requests this connection started
        self._conn_writers.add(writer)
        try:
            while True:
                msg = await read_frame(reader)
                t = msg.get("t")
                if t == "req":
                    rid = msg["rid"]
                    if self._stopping.is_set():
                        # Draining: refuse new work so callers retry
                        # elsewhere.
                        await send({"t": "err", "rid": rid,
                                    "e": INCOMPLETE})
                        continue
                    ctx = Context.from_wire(msg.get("ctx"))
                    ctx.values["request_id"] = rid
                    task = asyncio.create_task(
                        self._run_request(rid, msg.get("p"), ctx, send))
                    self._inflight[rid] = (task, ctx)
                    conn_rids.add(rid)
                    task.add_done_callback(
                        lambda _, rid=rid: conn_rids.discard(rid))
                elif t == "stop":
                    entry = self._inflight.get(msg["rid"])
                    if entry:
                        entry[1].stop_generating()
                elif t == "kill":
                    entry = self._inflight.get(msg["rid"])
                    if entry:
                        entry[1].kill()
                        entry[0].cancel()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            # Caller vanished: kill its in-flight work, so the engine
            # frees the slots too.
            for rid in list(conn_rids):
                entry = self._inflight.get(rid)
                if entry:
                    entry[1].kill()
                    entry[0].cancel()
            self._conn_writers.discard(writer)
            writer.close()

    async def _send_err(self, send, rid: str, token: str) -> None:
        try:
            await send({"t": "err", "rid": rid, "e": token})
        except (ConnectionError, OSError):
            pass

    async def _run_request(self, rid: str, request: Any, ctx: Context,
                           send) -> None:
        # Per-stream sequence numbers: data frames carry "s"=0,1,2,... and
        # the final frame carries the total, so the client detects a lost
        # or duplicated frame.
        seq = 0
        try:
            async for response in self._handler(request, ctx):
                if ctx.is_killed:
                    break
                await send({"t": "data", "rid": rid, "p": response, "s": seq})
                seq += 1
            if ctx.is_killed:
                # A kill issued by our own drain (shutdown) is an incomplete
                # stream the caller should migrate, not a client kill echo.
                await send({"t": "err", "rid": rid,
                            "e": (INCOMPLETE
                                  if self._stopping.is_set() else KILLED)})
            else:
                await send({"t": "final", "rid": rid, "s": seq})
        except asyncio.CancelledError:
            if self._stopping.is_set():
                # Drain deadline hit: send the typed incomplete frame so the
                # caller's migration re-issues at once.
                await self._send_err(send, rid,
                                     INCOMPLETE)
            raise
        except (AdapterNotFoundError, OverloadedError) as exc:
            # An unknown LoRA adapter (404 at the front) or no free adapter
            # slot (503): typed on the wire, as the reference's server
            # types them.
            await self._send_err(send, rid, f"{exc.WIRE_PREFIX}{exc}")
        except (ValueError, InvalidRequestError) as exc:
            # Request validation: typed on the wire so the front answers
            # 400, not 500.
            await self._send_err(send, rid,
                                 f"{InvalidRequestError.WIRE_PREFIX}{exc}")
        except GeneratorExit:
            # The handler signals an incomplete stream (migration trigger).
            await self._send_err(send, rid, INCOMPLETE)
        except Exception as exc:  # noqa: BLE001 — ship to caller
            log.warning("handler error for %s: %s", rid, exc, exc_info=True)
            await self._send_err(send, rid, f"{type(exc).__name__}: {exc}")
        finally:
            self._inflight.pop(rid, None)

    async def shutdown(self, drain_s: float | None = None) -> None:
        """Deregister, then drain (graceful) or cancel (fast) in-flight
        work. ``drain_s`` overrides the constructed choice for this call:
        a positive value drains up to that deadline, 0 kills at once.
        Streams still running at the deadline are killed with a typed
        incomplete frame. A second call returns at once."""
        if self._server is None:
            return
        self._stopping.set()
        if self.instance is not None:
            try:
                await self._runtime.coordinator_client.kv_delete(
                    self.instance.path)
            except (ConnectionError, RuntimeError):
                pass
        if drain_s is not None:
            graceful, budget = drain_s > 0, drain_s
        else:
            graceful = self._graceful
            budget = self._runtime.config.shutdown_timeout_s
        if graceful:
            deadline = time.monotonic() + budget
            while self._inflight and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
        victims = list(self._inflight.values())
        for task, ctx in victims:
            ctx.kill()
            task.cancel()
        if victims:
            # Let the killed handlers flush their typed incomplete frames
            # before the sockets close; bounded so a wedged handler cannot
            # stall shutdown.
            try:
                await asyncio.wait_for(
                    asyncio.gather(*(t for t, _ in victims),
                                   return_exceptions=True), 2.0)
            except asyncio.TimeoutError:
                pass
        if self._server is not None:
            self._server.close()
            # wait_closed() waits for every connection handler; close the
            # peer connections so it can.
            for writer in list(self._conn_writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None
