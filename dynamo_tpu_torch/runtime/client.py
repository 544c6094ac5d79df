"""Endpoint client: the egress half of the request plane (copy of
``dynamo_tpu.runtime.client.EndpointClient``).

Per-worker circuit breakers (``runtime/overload.py``'s ``BreakerBoard``,
``breakers``): connect failures, lost connections, frame gaps, idle
deadlines, ``incomplete`` and ``overloaded`` error frames and handler
errors count against the worker; a caller's fault (``invalid_request``,
``rate_limited``, ``adapter_not_found``, ``role_transition``, an echoed
``killed``) does not. A stream that delivered frames and failed nothing
is a success whose latency sample is its first frame's. Round-robin and
random selection skip open breakers (``direct`` does not); when every
instance is open the client raises ``OverloadedError`` and journals a
throttled ``shed`` event, as the reference does.

Instances are discovered from a watch of the endpoint's ``instances/``
prefix, and the live set follows leases as they appear and expire.
Responses stream back multiplexed by ``rid`` on one duplex TCP connection
per instance. Routing: ``round_robin``, ``random`` or ``direct``.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import time
import uuid
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime.component import (Endpoint, Instance,
                                                instance_prefix)
from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import (KILLED, AdapterNotFoundError,
                                             InvalidRequestError,
                                             NoInstancesError,
                                             OverloadedError,
                                             RateLimitedError,
                                             RoleTransitionError,
                                             StreamIncompleteError,
                                             error_from_wire)
from dynamo_tpu_torch.runtime.frame import read_frame, write_frame
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.overload import BreakerBoard


ROUTER_MODES = ("round_robin", "random", "direct")


class _InstanceConn:
    """One multiplexed connection to an instance."""

    def __init__(self, instance: Instance):
        self.instance = instance
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._streams: dict[str, asyncio.Queue] = {}
        self._reader_task: asyncio.Task | None = None
        self._send_lock = asyncio.Lock()
        self.alive = False
        # Set when the instance deregisters while streams are in flight:
        # the connection drains them and closes itself once idle.
        self.retire_when_idle = False

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.instance.host, self.instance.port)
        self.alive = True
        self._reader_task = asyncio.create_task(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await read_frame(self._reader)
                q = self._streams.get(msg.get("rid"))
                if q is None:
                    continue
                t = msg.get("t")
                if t == "data":
                    q.put_nowait(("data", msg.get("p"), msg.get("s")))
                elif t == "final":
                    q.put_nowait(("final", None, msg.get("s")))
                elif t == "err":
                    q.put_nowait(("err", msg.get("e"), None))
        except (asyncio.IncompleteReadError, ConnectionError, ValueError,
                OSError):
            pass
        finally:
            self.alive = False
            for q in self._streams.values():
                q.put_nowait(("lost", None, None))

    async def send(self, obj: dict) -> None:
        if not self.alive:
            raise ConnectionError("instance connection lost")
        async with self._send_lock:
            await write_frame(self._writer, obj)

    def open_stream(self, rid: str) -> asyncio.Queue:
        # Per-stream response frames: bounded by the request's token budget
        # (one data frame per engine output, then final); bounding here
        # would let a slow consumer block every stream on the connection.
        q: asyncio.Queue = asyncio.Queue()
        self._streams[rid] = q
        return q

    def close_stream(self, rid: str) -> None:
        self._streams.pop(rid, None)
        if self.retire_when_idle and not self._streams:
            self.close()

    def close(self) -> None:
        self.alive = False
        if self._reader_task:
            self._reader_task.cancel()
        if self._writer:
            self._writer.close()


class EndpointClient:
    def __init__(self, runtime, endpoint: Endpoint,
                 router_mode: str = "round_robin"):
        if router_mode not in ROUTER_MODES:
            raise ValueError(f"router_mode must be one of {ROUTER_MODES}, "
                             f"got {router_mode!r}")
        self._runtime = runtime
        self._endpoint = endpoint
        self.router_mode = router_mode
        self._instances: dict[int, Instance] = {}
        self._conns: dict[int, _InstanceConn] = {}
        self._conn_locks: dict[int, asyncio.Lock] = {}
        self._rr = itertools.count()
        self._watch = None
        self._watch_task: asyncio.Task | None = None
        self._instances_event = asyncio.Event()
        # Per-worker circuit breakers; the KV router's scheduler shares
        # this board.
        self.breakers = BreakerBoard(runtime.config.overload,
                                     metrics=runtime.metrics)
        # Throttle for the all-breakers-open journal shed event.
        self._breakers_shed_t = -1e18
        self._breakers_shed_n = 0

    async def start(self) -> None:
        prefix = instance_prefix(self._endpoint.component.namespace,
                                 self._endpoint.component.name,
                                 self._endpoint.name)
        self._watch = await self._runtime.coordinator_client.watch_prefix(
            prefix)
        for entry in self._watch.snapshot:
            self._add_instance(Instance.from_wire(entry["v"]))
        self._watch_task = asyncio.create_task(self._watch_loop())

    def _add_instance(self, instance: Instance) -> None:
        self._instances[instance.instance_id] = instance
        self._instances_event.set()

    def _remove_instance(self, instance_id: int) -> None:
        self._instances.pop(instance_id, None)
        self.breakers.remove(instance_id)
        conn = self._conns.pop(instance_id, None)
        if conn:
            # Deregistration only stops NEW routing to the instance:
            # in-flight streams on a healthy connection drain, for at most
            # retire_drain_s. A crashed worker closes the connection itself
            # (an immediate "lost" wakeup).
            if conn._streams:
                conn.retire_when_idle = True
                asyncio.get_running_loop().call_later(
                    self._runtime.config.retire_drain_s, conn.close)
            else:
                conn.close()
        if not self._instances:
            self._instances_event.clear()

    async def _watch_loop(self) -> None:
        async for event in self._watch:
            if event["event"] == "put":
                self._add_instance(Instance.from_wire(event["value"]))
            else:
                # The key's tail is the hex instance id.
                try:
                    iid = int(event["key"].rsplit("/", 1)[-1], 16)
                except ValueError:
                    continue
                self._remove_instance(iid)

    # -- instance selection ---------------------------------------------------
    def instance_ids(self) -> list[int]:
        return sorted(self._instances)

    async def wait_for_instances(self, timeout: float = 30.0) -> list[int]:
        try:
            await asyncio.wait_for(self._instances_event.wait(), timeout)
        except asyncio.TimeoutError:
            raise NoInstancesError(
                f"no instances for {self._endpoint.path} after {timeout}s"
            ) from None
        return self.instance_ids()

    def _select(self, mode: str, instance_id: int | None) -> Instance:
        ids = self.instance_ids()
        if not ids:
            raise NoInstancesError(f"no instances for {self._endpoint.path}")
        if mode == "direct":
            if instance_id not in self._instances:
                raise NoInstancesError(
                    f"instance {instance_id:x} not found for "
                    f"{self._endpoint.path}")
            return self._instances[instance_id]
        if mode not in ROUTER_MODES:
            raise ValueError(f"router mode must be one of {ROUTER_MODES}, "
                             f"got {mode!r}")
        # Open breakers are skipped (direct above bypasses them: the KV
        # router has filtered already, and admin verbs and canaries must
        # reach a sick worker on purpose).
        healthy = self.breakers.admitted(ids)
        if not healthy:
            now = time.monotonic()
            if now - self._breakers_shed_t >= 1.0:
                # One event speaks for the storm, with the suppressed tally.
                journal.emit(
                    EventKind.SHED,
                    cause=journal.recent_ref(EventKind.BREAKER_TRANSITION),
                    reason="breakers_open", instances=len(ids),
                    endpoint=self._endpoint.path,
                    suppressed=self._breakers_shed_n)
                self._breakers_shed_t = now
                self._breakers_shed_n = 0
            else:
                self._breakers_shed_n += 1
            raise OverloadedError(
                f"all {len(ids)} instances for {self._endpoint.path} are "
                "circuit-open; retry shortly")
        if mode == "random":
            return self._instances[random.choice(healthy)]
        return self._instances[healthy[next(self._rr) % len(healthy)]]

    async def _conn_for(self, instance: Instance) -> _InstanceConn:
        # Per-instance lock: concurrent first requests share one connection
        # instead of racing open_connection and leaking the losers.
        lock = self._conn_locks.setdefault(instance.instance_id,
                                           asyncio.Lock())
        async with lock:
            conn = self._conns.get(instance.instance_id)
            if conn is None or not conn.alive:
                conn = _InstanceConn(instance)
                await conn.connect()
                self._conns[instance.instance_id] = conn
            return conn

    # -- request issue --------------------------------------------------------
    async def generate(self, request: Any, context: Context | None = None,
                       mode: str | None = None,
                       instance_id: int | None = None) -> AsyncIterator[Any]:
        """Route a request (``mode`` defaults to the client's; an
        ``instance_id`` routes direct) and return its response stream."""
        ctx = context or Context()
        mode = mode or self.router_mode
        if instance_id is not None:
            mode = "direct"
        instance = self._select(mode, instance_id)
        return self._stream(instance, request, ctx)

    async def direct(self, request: Any, instance_id: int,
                     context: Context | None = None) -> AsyncIterator[Any]:
        return await self.generate(request, context, mode="direct",
                                   instance_id=instance_id)

    async def _stream(self, instance: Instance, request: Any, ctx: Context
                      ) -> AsyncIterator[Any]:
        rid = uuid.uuid4().hex
        iid = instance.instance_id
        breakers = self.breakers
        try:
            conn = await self._conn_for(instance)
            q = conn.open_stream(rid)
            await conn.send({"t": "req", "rid": rid, "ctx": ctx.to_wire(),
                             "p": request})
        except (ConnectionError, OSError) as exc:
            # Discovery stays the one source of truth for the routing set
            # (removal happens on a watch delete event); just drop the dead
            # connection so the next attempt redials.
            conn = self._conns.pop(instance.instance_id, None)
            if conn:
                conn.close()
            breakers.record_failure(iid)
            raise StreamIncompleteError(
                f"Stream ended before generation completed "
                f"(connect to {instance.instance_id:x} failed: {exc})"
            ) from exc
        breakers.on_dispatch(iid)
        # The worker that served the request: the last dispatch wins, which
        # is what migration wants.
        ctx.values["worker_id"] = f"{iid:x}"
        sent_t = time.monotonic()
        first_latency: float | None = None
        failed = False
        stop_sent = False
        # A stop/kill issued while we are blocked on the queue must reach
        # the worker at once: a watcher pushes a wakeup into the stream's
        # queue when the context cancels.
        stop_t = asyncio.ensure_future(ctx.wait_stopped())
        stop_t.add_done_callback(lambda _: q.put_nowait(("wake", None, None)))
        # Data frames carry per-stream sequence numbers: a gap fails typed
        # instead of silently shortening the stream, and a duplicate is
        # dropped instead of delivered twice.
        expected_seq = 0
        idle_s = self._runtime.config.stream_idle_timeout_s
        try:
            while True:
                if ctx.is_killed and not stop_sent:
                    stop_sent = True
                    try:
                        await conn.send({"t": "kill", "rid": rid})
                    except (ConnectionError, OSError):
                        pass
                    return
                if ctx.is_stopped and not stop_sent:
                    stop_sent = True
                    try:
                        await conn.send({"t": "stop", "rid": rid})
                    except (ConnectionError, OSError):
                        pass
                try:
                    # An idle deadline between frames: a zombie connection
                    # becomes a typed migration trigger, not a hang.
                    kind, payload, seq = await asyncio.wait_for(
                        q.get(), idle_s if idle_s and idle_s > 0 else None)
                except asyncio.TimeoutError:
                    try:
                        await conn.send({"t": "kill", "rid": rid})
                    except (ConnectionError, OSError):
                        pass
                    failed = True
                    breakers.record_failure(iid)
                    raise StreamIncompleteError(
                        f"Stream ended before generation completed (no "
                        f"frames from {instance.instance_id:x} for "
                        f"{idle_s:g}s)") from None
                if kind == "wake":
                    continue  # cancellation wakeup; the loop top sends it
                if kind == "data":
                    if first_latency is None:
                        first_latency = time.monotonic() - sent_t
                    if seq is not None:
                        if seq < expected_seq:
                            continue  # duplicate frame: already delivered
                        if seq > expected_seq:
                            failed = True
                            breakers.record_failure(iid)
                            raise StreamIncompleteError(
                                "Stream ended before generation completed "
                                f"(frame gap: expected #{expected_seq}, "
                                f"got #{seq})")
                        expected_seq += 1
                    yield payload
                elif kind == "final":
                    if seq is not None and seq != expected_seq:
                        failed = True
                        breakers.record_failure(iid)
                        raise StreamIncompleteError(
                            "Stream ended before generation completed "
                            f"(final after #{expected_seq} of {seq} frames)")
                    return
                elif kind == "err":
                    exc = error_from_wire(payload)
                    # A caller's fault is no worker-health signal.
                    if not (isinstance(exc, (InvalidRequestError,
                                             RateLimitedError,
                                             AdapterNotFoundError,
                                             RoleTransitionError))
                            or payload == KILLED):
                        failed = True
                        breakers.record_failure(iid)
                    raise exc
                else:  # lost
                    failed = True
                    breakers.record_failure(iid)
                    raise StreamIncompleteError(
                        "Stream ended before generation completed "
                        f"(connection to {instance.instance_id:x} lost)")
        finally:
            # A stream that delivered frames and failed nothing is a
            # success even when the consumer stops early; its latency
            # sample is the first frame's (total time scales with
            # max_tokens, the client's choice).
            if not failed and first_latency is not None:
                breakers.record_success(iid, first_latency)
            stop_t.cancel()
            conn.close_stream(rid)

    async def close(self) -> None:
        if self._watch_task:
            self._watch_task.cancel()
        if self._watch:
            await self._watch.cancel()
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
