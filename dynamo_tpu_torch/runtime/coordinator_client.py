"""Async client for the control-plane coordinator (copy of
``dynamo_tpu.runtime.coordinator_client`` on the port's frame codec).

One connection plays the roles of an etcd client (kv_create/kv_put/watch
and a primary lease kept alive in the background, re-granted after expiry
and after a coordinator restart) and of a NATS client
(publish/subscribe/queues/object store).
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime.frame import read_frame, write_frame
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.retry import Backoff, policies

log = get_logger("coordinator_client")


class WatchStream:
    """A prefix watch: initial snapshot + live put/delete events.

    Reference: PrefixWatcher from kv_get_and_watch_prefix (etcd.rs:310)."""

    def __init__(self, client: "CoordinatorClient", watch_id: int,
                 snapshot: list[dict], prefix: str = ""):
        self._client = client
        self.watch_id = watch_id
        self.snapshot = snapshot
        self.prefix = prefix
        # Watch deltas must never be dropped (a lost DELETE strands a
        # dead instance in discovery forever); volume is bounded by
        # actual cluster-state churn, not request traffic.
        # dtpu: ignore[unbounded-queue] -- lossless-by-contract control stream
        self.events: asyncio.Queue[dict] = asyncio.Queue()
        # Keys this watch has reported as present — lets a reconnect
        # synthesize DELETE events for keys that vanished with the old
        # coordinator (consumers like instance discovery only remove
        # entries on deletes).
        self.known_keys: set[str] = {item["k"] for item in snapshot}
        # While a reconnect replays the snapshot, live events buffer here
        # so a pre-replay put can't be overwritten by the older snapshot.
        self.paused = False
        self._buffer: list[dict] = []

    def deliver(self, event: dict) -> None:
        if event["event"] == "put":
            self.known_keys.add(event["key"])
        else:
            self.known_keys.discard(event["key"])
        if self.paused:
            self._buffer.append(event)
        else:
            self.events.put_nowait(event)

    def flush(self) -> None:
        self.paused = False
        for ev in self._buffer:
            # Re-apply to known_keys: a reconnect replay overwrites the
            # set from its snapshot, which predates these buffered events.
            if ev["event"] == "put":
                self.known_keys.add(ev["key"])
            else:
                self.known_keys.discard(ev["key"])
            self.events.put_nowait(ev)
        self._buffer.clear()

    def __aiter__(self) -> AsyncIterator[dict]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[dict]:
        while True:
            yield await self.events.get()

    async def cancel(self) -> None:
        self._client._watches.pop(self.watch_id, None)
        try:
            await self._client._request({"m": "unwatch", "watch_id": self.watch_id})
        except ConnectionError:
            pass


class Subscription:
    """A pub/sub subscription stream (reference: NATS subscribe)."""

    def __init__(self, client: "CoordinatorClient", sub_id: int,
                 subject: str = ""):
        self._client = client
        self.sub_id = sub_id
        self.subject = subject
        # Control-plane pubsub: volume bounded by cluster churn
        # (KV events/metrics), not user traffic.
        # dtpu: ignore[unbounded-queue] -- see above
        self.messages: asyncio.Queue[dict] = asyncio.Queue()

    def __aiter__(self) -> AsyncIterator[dict]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[dict]:
        while True:
            yield await self.messages.get()

    async def cancel(self) -> None:
        self._client._subs.pop(self.sub_id, None)
        try:
            await self._client._request({"m": "unsubscribe", "sub": self.sub_id})
        except ConnectionError:
            pass


class CoordinatorClient:
    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._watches: dict[int, WatchStream] = {}
        self._subs: dict[int, Subscription] = {}
        self._reader_task: asyncio.Task | None = None
        self._keepalive_task: asyncio.Task | None = None
        self._reconnect_task: asyncio.Task | None = None
        self._send_lock = asyncio.Lock()
        self.primary_lease_id: int | None = None
        self._lease_ttl_s = 10.0
        self._lease_recreated_callbacks: list = []
        self._regrant_lock = asyncio.Lock()
        self._closed = False
        # False between a detected disconnect and a completed reconnect:
        # _request fails fast instead of writing into a dead socket whose
        # reply future nobody would ever resolve.
        self._connected = True

    @classmethod
    async def connect(cls, host: str, port: int, lease_ttl_s: float = 10.0
                      ) -> "CoordinatorClient":
        client = cls(host, port)
        last: Exception | None = None
        backoff = Backoff(policies.COORD_CONNECT)
        while True:
            try:
                client._reader, client._writer = await asyncio.open_connection(host, port)
                break
            except OSError as exc:
                last = exc
                if not await backoff.sleep():
                    raise ConnectionError(
                        f"coordinator unreachable at {host}:{port}: {last}")
        client._reader_task = asyncio.create_task(client._read_loop())
        # Primary lease: liveness anchor for everything this process registers
        # (reference: etcd primary lease, transports/etcd/lease.rs).
        client._lease_ttl_s = lease_ttl_s
        client.primary_lease_id = await client.lease_grant(lease_ttl_s)
        client._keepalive_task = asyncio.create_task(
            client._keepalive_loop(client.primary_lease_id, lease_ttl_s / 3))
        return client

    async def close(self, revoke_lease: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        if self._keepalive_task:
            self._keepalive_task.cancel()
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if revoke_lease and self.primary_lease_id is not None:
            try:
                await self._request({"m": "lease_revoke", "lease": self.primary_lease_id})
            except (ConnectionError, asyncio.IncompleteReadError):
                pass
        if self._reader_task:
            self._reader_task.cancel()
        if self._writer:
            self._writer.close()

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                msg = await read_frame(self._reader)
                if "i" in msg and msg["i"] is not None and ("ok" in msg):
                    fut = self._pending.pop(msg["i"], None)
                    if fut and not fut.done():
                        if msg["ok"]:
                            fut.set_result(msg.get("r"))
                        else:
                            fut.set_exception(RuntimeError(msg.get("e")))
                elif "w" in msg:
                    watch = self._watches.get(msg["w"])
                    if watch:
                        watch.deliver(
                            {"event": msg["ev"], "key": msg["k"], "value": msg.get("v")})
                elif "s" in msg:
                    sub = self._subs.get(msg["s"])
                    if sub:
                        sub.messages.put_nowait(
                            {"subject": msg["subject"], "payload": msg["payload"]})
        except asyncio.CancelledError:
            self._connected = False
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("coordinator connection lost"))
            self._pending.clear()
        except Exception:  # noqa: BLE001 — ANY read failure is a disconnect
            # (ConnectionError subclasses, plain OSError like ETIMEDOUT,
            # or a corrupt-frame decode error).
            self._connected = False
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("coordinator connection lost"))
            self._pending.clear()
            if not self._closed:
                # Coordinator went away (restart/crash): reconnect in the
                # background and rebuild this client's server-side state.
                self._reconnect_task = asyncio.ensure_future(
                    self._reconnect())

    async def _reconnect(self) -> None:
        """Survive a coordinator restart: redial (forever, with capped
        jittered backoff from policies.COORD_RECONNECT, until closed),
        re-grant the primary lease, replay registrations (lease-recreated
        callbacks), and re-establish every live watch and subscription —
        synthesizing DELETE events for keys that vanished with the old
        coordinator. Server-side queue contents do not survive (stated
        posture: the coordinator is a restartable but non-persistent
        control plane)."""
        if self._keepalive_task:
            self._keepalive_task.cancel()
        log.warning("coordinator connection lost; reconnecting to %s:%d",
                    self.host, self.port)
        backoff = Backoff(policies.COORD_RECONNECT)
        while not self._closed:
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self.host, self.port)
                break
            except OSError:
                await backoff.sleep()
        if self._closed:
            return
        # Fail anything that slipped into the pending map while the old
        # socket was dying, then open for business on the new one.
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(
                    ConnectionError("coordinator connection lost"))
        self._pending.clear()
        self._reader_task = asyncio.create_task(self._read_loop())
        self._connected = True
        try:
            self.primary_lease_id = await self.lease_grant(self._lease_ttl_s)
            self._keepalive_task = asyncio.create_task(
                self._keepalive_loop(self.primary_lease_id,
                                     self._lease_ttl_s / 3))
            # Re-establish watches first so replayed registrations (ours and
            # other clients') flow into them as put events. Live events
            # buffer while each watch's snapshot replays, so a fresh put
            # can't be clobbered by the older snapshot value.
            for watch in list(self._watches.values()):
                watch.paused = True
                result = await self._request(
                    {"m": "watch", "k": watch.prefix, "wid": watch.watch_id})
                new_keys = {item["k"] for item in result["snapshot"]}
                for key in sorted(watch.known_keys - new_keys):
                    watch.events.put_nowait(
                        {"event": "delete", "key": key, "value": None})
                for item in result["snapshot"]:
                    watch.events.put_nowait(
                        {"event": "put", "key": item["k"],
                         "value": item["v"]})
                watch.known_keys = new_keys
                watch.flush()
            for sub in list(self._subs.values()):
                await self._request({"m": "subscribe", "subject": sub.subject,
                                     "sid": sub.sub_id})
            for cb in list(self._lease_recreated_callbacks):
                try:
                    await cb(self.primary_lease_id)
                except Exception:  # noqa: BLE001
                    log.exception("reconnect registration replay failed")
            log.info("coordinator reconnected; state replayed "
                     "(%d watches, %d subs, %d registrations)",
                     len(self._watches), len(self._subs),
                     len(self._lease_recreated_callbacks))
        except Exception:  # noqa: BLE001
            # Replay failed (server rejected or died again): force the read
            # loop down so the disconnect path schedules a fresh reconnect
            # — a half-replayed client must not linger looking healthy.
            log.exception("reconnect state replay failed; forcing redial")
            for watch in list(self._watches.values()):
                watch.flush()
            if self._writer is not None:
                self._writer.close()

    def on_lease_recreated(self, callback) -> None:
        """Register an async callback invoked (with the new lease id) after the
        primary lease had to be re-granted — used by endpoint servers to re-put
        their registrations so a transient stall doesn't silently drain traffic."""
        self._lease_recreated_callbacks.append(callback)

    async def renew_lease(self) -> None:
        """Renew the primary lease now, ahead of a step known to stall the
        event loop (and so the keepalive task) for seconds."""
        await self._request({"m": "lease_keepalive",
                             "lease": self.primary_lease_id})

    async def _keepalive_loop(self, lease_id: int, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            try:
                await self._request({"m": "lease_keepalive", "lease": lease_id})
            except ConnectionError:
                # The read loop schedules the reconnect (which restarts a
                # fresh keepalive task); this one just winds down.
                log.warning("coordinator connection lost; keepalive stopped")
                return
            except RuntimeError as exc:
                if "not found" not in str(exc):
                    log.warning("lease keepalive error (will retry): %s", exc)
                    continue
                # Lease expired server-side (e.g. event-loop stall past TTL):
                # re-grant and let registrants re-register.
                try:
                    await self._regrant_primary()
                    lease_id = self.primary_lease_id
                except (ConnectionError, RuntimeError) as exc2:
                    log.error("lease re-grant failed: %s", exc2)
                    return

    async def _regrant_primary(self) -> None:
        """Re-grant the primary lease after server-side expiry and replay
        the registration callbacks. Safe under concurrency: whoever loses
        the lock re-checks liveness first."""
        async with self._regrant_lock:
            try:
                await self._request({"m": "lease_keepalive",
                                     "lease": self.primary_lease_id})
                return  # someone else already re-granted
            except RuntimeError:
                pass
            log.error("primary lease %s expired; re-granting",
                      self.primary_lease_id)
            self.primary_lease_id = await self.lease_grant(self._lease_ttl_s)
            for cb in list(self._lease_recreated_callbacks):
                try:
                    await cb(self.primary_lease_id)
                except Exception:  # noqa: BLE001
                    log.exception("lease-recreated callback failed")

    # Hard ceiling on any single control-plane round trip. Ops complete
    # in milliseconds when the coordinator is healthy; one that can't
    # answer within this deadline is indistinguishable from a
    # partitioned one, so the reply wait must not be unbounded (a lost
    # reply frame would otherwise park the caller forever).
    REQUEST_TIMEOUT_S = 30.0

    async def _request(self, msg: dict, timeout: float | None = None) -> Any:
        if (self._writer is None or self._writer.is_closing()
                or not self._connected):
            raise ConnectionError("not connected")
        rid = next(self._ids)
        msg["i"] = rid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        async with self._send_lock:
            await write_frame(self._writer, msg)
        try:
            return await asyncio.wait_for(
                fut, self.REQUEST_TIMEOUT_S if timeout is None else timeout)
        except asyncio.TimeoutError:
            self._pending.pop(rid, None)
            # Force the connection down so the read loop schedules a
            # reconnect — a silently unresponsive control plane must be
            # treated exactly like a dead one.
            if self._writer is not None and not self._closed:
                self._writer.close()
            raise ConnectionError(
                f"coordinator request {msg.get('m')!r} timed out") from None

    # -- etcd-shaped API ------------------------------------------------------
    async def lease_grant(self, ttl: float) -> int:
        return await self._request({"m": "lease_grant", "ttl": ttl})

    async def lease_revoke(self, lease_id: int) -> None:
        await self._request({"m": "lease_revoke", "lease": lease_id})

    async def kv_put(self, key: str, value: Any, lease_id: int | None = None,
                     use_primary_lease: bool = False) -> int:
        if use_primary_lease:
            return await self._with_primary_lease(
                lambda lease: self._request(
                    {"m": "kv_put", "k": key, "v": value, "lease": lease}))
        return await self._request({"m": "kv_put", "k": key, "v": value,
                                    "lease": lease_id})

    async def kv_create(self, key: str, value: Any, lease_id: int | None = None,
                        use_primary_lease: bool = False) -> bool:
        """Atomic create; False if the key already exists (etcd.rs kv_create)."""
        if use_primary_lease:
            rev = await self._with_primary_lease(
                lambda lease: self._request(
                    {"m": "kv_create", "k": key, "v": value, "lease": lease}))
        else:
            rev = await self._request({"m": "kv_create", "k": key, "v": value,
                                       "lease": lease_id})
        return rev is not None

    async def _with_primary_lease(self, fn):
        """Run a lease-attached request; if the primary lease expired while
        we weren't looking (event-loop stall past the TTL), re-grant it and
        retry once — registration must not fail just because the process
        was briefly too busy to keep its lease alive."""
        try:
            return await fn(self.primary_lease_id)
        except RuntimeError as exc:
            if "not found" not in str(exc):
                raise
            await self._regrant_primary()
            return await fn(self.primary_lease_id)

    async def kv_get(self, key: str) -> Any | None:
        result = await self._request({"m": "kv_get", "k": key})
        return None if result is None else result["v"]

    async def kv_get_prefix(self, prefix: str) -> list[dict]:
        return await self._request({"m": "kv_get_prefix", "k": prefix})

    async def kv_delete(self, key: str) -> bool:
        return await self._request({"m": "kv_delete", "k": key})

    async def kv_delete_prefix(self, prefix: str) -> int:
        return await self._request({"m": "kv_delete_prefix", "k": prefix})

    async def watch_prefix(self, prefix: str) -> WatchStream:
        # Client allocates the watch id and registers the stream BEFORE the
        # request, so events racing the watch response are never dropped.
        wid = next(self._ids)
        watch = WatchStream(self, wid, [], prefix=prefix)
        self._watches[wid] = watch
        try:
            result = await self._request({"m": "watch", "k": prefix, "wid": wid})
        except BaseException:
            self._watches.pop(wid, None)
            raise
        watch.snapshot = result["snapshot"]
        watch.known_keys = {item["k"] for item in watch.snapshot}
        return watch

    # -- NATS-shaped API ------------------------------------------------------
    async def publish(self, subject: str, payload: Any) -> None:
        await self._request({"m": "publish", "subject": subject, "payload": payload})

    async def subscribe(self, subject: str) -> Subscription:
        sid = next(self._ids)
        sub = Subscription(self, sid, subject=subject)
        self._subs[sid] = sub
        try:
            await self._request({"m": "subscribe", "subject": subject, "sid": sid})
        except BaseException:
            self._subs.pop(sid, None)
            raise
        return sub

    async def queue_push(self, queue: str, item: Any) -> None:
        await self._request({"m": "queue_push", "queue": queue, "item": item})

    async def queue_pop(self, queue: str, timeout: float = 0.0) -> Any | None:
        # The server blocks up to ``timeout`` before answering None, so
        # the wire deadline must sit beyond it.
        result = await self._request(
            {"m": "queue_pop", "queue": queue, "timeout": timeout},
            timeout=timeout + self.REQUEST_TIMEOUT_S)
        return None if result is None else result["item"]

    async def queue_len(self, queue: str) -> int:
        return await self._request({"m": "queue_len", "queue": queue})

    async def object_put(self, key: str, data: bytes) -> None:
        await self._request({"m": "object_put", "k": key, "v": data})

    async def object_get(self, key: str) -> bytes | None:
        return await self._request({"m": "object_get", "k": key})
