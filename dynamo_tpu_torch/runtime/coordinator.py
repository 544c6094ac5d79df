"""Built-in control-plane coordinator: KV + leases + watch + pub/sub + queues
(copy of ``dynamo_tpu.runtime.coordinator``, on the port's frame codec, so
either package's clients talk to it).

One asyncio TCP server with the union of the semantics the deployment
uses:

- etcd-shaped:  kv_put / kv_create (atomic create) / kv_get /
  kv_get_prefix / kv_delete / kv_delete_prefix, lease
  grant/keepalive/revoke with TTL expiry cascading key deletes, and
  prefix watches streaming put/delete events after a snapshot.
- NATS-shaped:  publish/subscribe on '.'-separated subjects with '*' and
  trailing '>' wildcards, persistent work queues with a blocking pop, and
  an object store (ships tokenizer artifacts).

Liveness: instance registration keys are attached to a lease; process
death => keepalives stop => lease expires => watchers see delete events
and deregister the worker. The coordinator is NOT on the data path (KV
blocks and token streams never transit it).

    python -m dynamo_tpu_torch.runtime.coordinator --host 127.0.0.1 --port 4222

prints ``COORDINATOR_READY port=N`` once it listens (``--port 0`` picks a
free port) and exits 0 on SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import signal
import time
from collections import deque
from typing import Any

from dynamo_tpu_torch.runtime.frame import read_frame, write_frame
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("coordinator")


class _Lease:
    __slots__ = ("id", "ttl", "expires_at", "keys")

    def __init__(self, lease_id: int, ttl: float):
        self.id = lease_id
        self.ttl = ttl
        self.expires_at = time.monotonic() + ttl
        self.keys: set[str] = set()

    def refresh(self) -> None:
        self.expires_at = time.monotonic() + self.ttl


OUTBOX_LIMIT = 4096  # frames buffered per connection before we drop the peer


class _Conn:
    """Per-client connection state. Watch/sub ids are allocated by the client
    (unique per connection) so the client can register its event queue before
    the first event can possibly arrive.

    Sends go through a bounded per-connection outbox drained by a writer task,
    so one stalled client socket can never block KV mutations, lease expiry, or
    fan-out to other clients; a client that falls OUTBOX_LIMIT frames behind is
    disconnected (slow-consumer policy, as NATS does)."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.watches: dict[int, str] = {}  # wid -> prefix
        self.subs: dict[int, str] = {}  # sid -> pattern
        self.closed = False
        # Control-plane writer queue: producers are coordinator-local
        # event fan-out (watch/pubsub deltas, no user payload
        # amplification); bounding would make kv_put on one slow peer
        # block every other peer's watch delivery.
        self._outbox: asyncio.Queue = asyncio.Queue()
        self._writer_task = asyncio.create_task(self._write_loop())

    async def _write_loop(self) -> None:
        try:
            while True:
                obj = await self._outbox.get()
                await write_frame(self.writer, obj)
        except asyncio.CancelledError:
            raise  # close() cancelled us; finally still runs the cleanup
        except (ConnectionError, OSError):
            pass
        finally:
            self.closed = True
            self.writer.close()

    async def send(self, obj: Any) -> None:
        if self.closed:
            return
        if self._outbox.qsize() >= OUTBOX_LIMIT:
            log.warning("dropping slow coordinator client (outbox full)")
            self.close()
            return
        self._outbox.put_nowait(obj)

    def close(self) -> None:
        self.closed = True
        self._writer_task.cancel()


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style matching: tokens split on '.', '*' matches one token,
    trailing '>' matches the rest."""
    pt, st = pattern.split("."), subject.split(".")
    for i, p in enumerate(pt):
        if p == ">":
            return True
        if i >= len(st):
            return False
        if p != "*" and p != st[i]:
            return False
    return len(pt) == len(st)


class Coordinator:
    """The control-plane server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._server: asyncio.AbstractServer | None = None
        self._ids = itertools.count(1)
        self._revision = 0
        # key -> (value, lease_id|None, revision)
        self._kv: dict[str, tuple[Any, int | None, int]] = {}
        self._leases: dict[int, _Lease] = {}
        self._conns: set[_Conn] = set()
        self._queues: dict[str, deque] = {}
        self._queue_waiters: dict[str, deque[asyncio.Future]] = {}
        self._objects: dict[str, bytes] = {}
        self._expiry_task: asyncio.Task | None = None

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._expiry_task = asyncio.create_task(self._expiry_loop())
        log.info("coordinator listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._expiry_task:
            self._expiry_task.cancel()
        if self._server:
            self._server.close()
            # Close live client connections so wait_closed() (which waits for
            # all handlers on Python 3.12+) can complete.
            for conn in list(self._conns):
                conn.close()
            await self._server.wait_closed()

    @property
    def url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    # -- lease expiry ---------------------------------------------------------
    async def _expiry_loop(self) -> None:
        while True:
            await asyncio.sleep(0.25)
            now = time.monotonic()
            expired = [l for l in self._leases.values() if l.expires_at < now]
            for lease in expired:
                log.info("lease %d expired; deleting %d keys", lease.id, len(lease.keys))
                await self._revoke(lease)

    async def _revoke(self, lease: _Lease) -> None:
        self._leases.pop(lease.id, None)
        for key in list(lease.keys):
            await self._delete_key(key)

    async def _delete_key(self, key: str) -> bool:
        entry = self._kv.pop(key, None)
        if entry is None:
            return False
        _, lease_id, _ = entry
        if lease_id is not None and lease_id in self._leases:
            self._leases[lease_id].keys.discard(key)
        await self._notify_watchers("delete", key, None)
        return True

    async def _notify_watchers(self, ev: str, key: str, value: Any) -> None:
        for conn in list(self._conns):
            for wid, prefix in list(conn.watches.items()):
                if key.startswith(prefix):
                    await conn.send({"w": wid, "ev": ev, "k": key, "v": value})

    # -- connection handling --------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = _Conn(writer)
        self._conns.add(conn)
        pending: set[asyncio.Task] = set()
        try:
            while True:
                msg = await read_frame(reader)
                if msg.get("m") == "queue_pop":
                    # The only op that can block (timed wait for an item):
                    # run it off the read loop, holding a strong reference so
                    # it isn't garbage-collected mid-flight. Everything else
                    # dispatches inline, preserving per-connection ordering
                    # (e.g. two kv_puts, or a put/delete pair).
                    task = asyncio.ensure_future(self._dispatch(conn, msg))
                    pending.add(task)
                    task.add_done_callback(pending.discard)
                else:
                    await self._dispatch(conn, msg)
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            for task in pending:
                task.cancel()
            conn.close()
            self._conns.discard(conn)

    async def _dispatch(self, conn: _Conn, msg: dict) -> None:
        rid = msg.get("i")
        try:
            result = await self._call(conn, msg)
            await conn.send({"i": rid, "ok": True, "r": result})
        except Exception as exc:  # noqa: BLE001 — report to client
            await conn.send({"i": rid, "ok": False, "e": f"{type(exc).__name__}: {exc}"})

    async def _call(self, conn: _Conn, msg: dict) -> Any:
        m = msg["m"]
        if m == "lease_grant":
            lease = _Lease(next(self._ids), float(msg["ttl"]))
            self._leases[lease.id] = lease
            return lease.id
        if m == "lease_keepalive":
            lease = self._leases.get(msg["lease"])
            if lease is None:
                raise KeyError(f"lease {msg['lease']} not found")
            lease.refresh()
            return True
        if m == "lease_revoke":
            lease = self._leases.get(msg["lease"])
            if lease is not None:
                await self._revoke(lease)
            return True
        if m == "kv_put":
            return await self._kv_put(msg["k"], msg["v"], msg.get("lease"))
        if m == "kv_create":
            if msg["k"] in self._kv:
                return None  # already exists (etcd txn failure)
            return await self._kv_put(msg["k"], msg["v"], msg.get("lease"))
        if m == "kv_get":
            entry = self._kv.get(msg["k"])
            return None if entry is None else {"v": entry[0], "rev": entry[2]}
        if m == "kv_get_prefix":
            prefix = msg["k"]
            return [{"k": k, "v": v, "rev": rev}
                    for k, (v, _, rev) in sorted(self._kv.items())
                    if k.startswith(prefix)]
        if m == "kv_delete":
            return await self._delete_key(msg["k"])
        if m == "kv_delete_prefix":
            keys = [k for k in self._kv if k.startswith(msg["k"])]
            for k in keys:
                await self._delete_key(k)
            return len(keys)
        if m == "watch":
            wid = msg["wid"]  # client-allocated
            conn.watches[wid] = msg["k"]
            snapshot = [{"k": k, "v": v, "rev": rev}
                        for k, (v, _, rev) in sorted(self._kv.items())
                        if k.startswith(msg["k"])]
            return {"watch_id": wid, "snapshot": snapshot}
        if m == "unwatch":
            conn.watches.pop(msg["watch_id"], None)
            return True
        if m == "publish":
            subject = msg["subject"]
            for sub_conn in list(self._conns):
                for sid, pattern in list(sub_conn.subs.items()):
                    if subject_matches(pattern, subject):
                        await sub_conn.send({"s": sid, "subject": subject,
                                             "payload": msg["payload"]})
            return True
        if m == "subscribe":
            sid = msg["sid"]  # client-allocated
            conn.subs[sid] = msg["subject"]
            return sid
        if m == "unsubscribe":
            conn.subs.pop(msg["sub"], None)
            return True
        if m == "queue_push":
            name = msg["queue"]
            waiters = self._queue_waiters.get(name)
            while waiters:
                fut = waiters.popleft()
                if not fut.done():
                    fut.set_result(msg["item"])
                    return True
            self._queues.setdefault(name, deque()).append(msg["item"])
            return True
        if m == "queue_pop":
            name = msg["queue"]
            q = self._queues.get(name)
            if q:
                return {"item": q.popleft()}
            timeout = msg.get("timeout", 0.0)
            if timeout <= 0:
                return None
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._queue_waiters.setdefault(name, deque()).append(fut)
            try:
                return {"item": await asyncio.wait_for(fut, timeout)}
            except asyncio.TimeoutError:
                return None
        if m == "queue_len":
            return len(self._queues.get(msg["queue"], ()))
        if m == "object_put":
            self._objects[msg["k"]] = msg["v"]
            return True
        if m == "object_get":
            return self._objects.get(msg["k"])
        raise ValueError(f"unknown method {m!r}")

    async def _kv_put(self, key: str, value: Any, lease_id: int | None) -> int:
        prev = self._kv.get(key)
        if prev is not None and prev[1] is not None and prev[1] != lease_id:
            # Re-owned key: detach from the previous lease so its expiry
            # doesn't delete the new owner's live key.
            old = self._leases.get(prev[1])
            if old is not None:
                old.keys.discard(key)
        if lease_id is not None:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise KeyError(f"lease {lease_id} not found")
            lease.keys.add(key)
        self._revision += 1
        self._kv[key] = (value, lease_id, self._revision)
        await self._notify_watchers("put", key, value)
        return self._revision


async def run_coordinator(host: str = "0.0.0.0", port: int = 4222) -> None:
    """Serve until SIGINT or SIGTERM."""
    loop = asyncio.get_running_loop()
    done = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, done.set)
    coord = Coordinator(host, port)
    await coord.start()
    try:
        print(f"COORDINATOR_READY port={coord.port}", flush=True)
        await done.wait()
    finally:
        await coord.stop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="dynamo_tpu_torch control-plane coordinator")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=4222,
                        help="0 picks a free port")
    args = parser.parse_args(argv)
    asyncio.run(run_coordinator(args.host, args.port))


if __name__ == "__main__":
    main()
