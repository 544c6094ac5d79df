"""Direct worker-to-worker KV data plane, socket path (counterpart of
``dynamo_tpu.llm.kv_plane``).

A prefill worker STAGES a prompt's parcel with its ``KvPlaneServer`` and
sends only a small ticket ``{"id", "addr", "shape", "dtype", "nbytes",
"prompt_len"}`` over the request plane; the decode worker's
``KvPlaneClient`` pulls the bulk bytes from the server's own listening
socket into a preallocated buffer. The bytes stay off the request plane
and the coordinator.

Wire: a control frame is a 4-byte big-endian length and a msgpack map
(``runtime/msgpack_lite.py``); bulk bytes follow raw. ``{"op": "pull",
"id"}`` is answered ``{"ok": true, **meta}`` (with ``"groups": [pages,
...]`` when the parcel streams as page groups along axis 3) and the
parcel's bytes, or ``{"err"}``. These are the JAX package's frames, so a
port sink pulls from a JAX source and back; a JAX ticket's ``jax_addr``
(its device path) is ignored here and the ticket is pulled over ``addr``.

A ticket is served exactly once: a concurrent second pull is refused
while the first transmits, and the parcel stays staged until its last
byte is on the wire, so a send that fails leaves it for the sink's retry
(``runtime/retry.py`` ``policies.KV_PULL``). Unclaimed tickets expire
after ``STAGED_TTL_S``. ``blocks`` requests (the G4 remote tier) are
answered as the reference answers them with no block source: empty.

Not ported: the same-host device path, the G4 block source and the
chaos hooks (ROADMAP items 8, 9 and 18).
"""

from __future__ import annotations

import asyncio
import collections
import socket
import struct
import threading
import time
from typing import Callable

import numpy as np

from dynamo_tpu_torch.engine.kv_quant import parcel_dtype, parcel_dtype_name
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.msgpack_lite import packb, unpackb
from dynamo_tpu_torch.runtime.retry import Backoff, policies

log = get_logger("kv_plane")

_LEN = struct.Struct(">I")
_MAX_CTRL = 64 * 1024 * 1024  # control frames stay small; bulk is raw
_SEND_CHUNK = 4 << 20

STAGED_TTL_S = 120.0  # unclaimed tickets expire (the sink went away)


def _send_ctrl(sock: socket.socket, obj: dict) -> None:
    body = packb(obj)
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_bulk_into(sock, memoryview(buf))
    return bytes(buf)


def _recv_ctrl(sock: socket.socket) -> dict:
    (length,) = _LEN.unpack(_recv_exact(sock, 4))
    if length > _MAX_CTRL:
        raise ValueError(f"control frame too large: {length}")
    return unpackb(_recv_exact(sock, length))


def _send_bulk(sock: socket.socket, arr: np.ndarray) -> None:
    data = memoryview(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))
    for off in range(0, len(data), _SEND_CHUNK):
        sock.sendall(data[off:off + _SEND_CHUNK])


def _recv_bulk_into(sock: socket.socket, buf: memoryview) -> None:
    """Fill ``buf`` from the socket."""
    got, n = 0, len(buf)
    while got < n:
        r = sock.recv_into(buf[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-payload")
        got += r


class _Staged:
    __slots__ = ("meta", "payload", "resolve", "groups", "t", "in_progress")

    def __init__(self, meta: dict, payload, resolve, groups):
        self.meta = meta
        self.payload = payload   # host parcel, once known
        self.resolve = resolve   # () -> parcel, or None
        # [(n_pages, () -> parcel of those pages)]: streamed page groups.
        self.groups = groups
        self.t = time.monotonic()
        # Claimed by a pull connection (under the server lock) until its
        # send ends: a second concurrent pull must not also transmit.
        self.in_progress = False

    def array(self) -> np.ndarray:
        if self.payload is None:
            self.payload = self.resolve()
            self.resolve = None
        return self.payload


class KvPlaneServer:
    """Source side: stages parcels for a direct pull. One per worker
    process; thread-based, so bulk socket I/O never shares the event loop
    with the request plane."""

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self.port = 0
        self._staged: dict[int, _Staged] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._running = False
        self._closed = threading.Event()  # wakes the GC thread on close
        self.transfers = 0
        self.bytes_out = 0
        self.block_requests = 0

    def stats(self) -> dict:
        with self._lock:
            staged = len(self._staged)
        return {"transfers": self.transfers, "bytes_out": self.bytes_out,
                "block_requests": self.block_requests, "staged": staged,
                "addr": self.address}

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, 0))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._running = True
        for target, name in ((self._accept_loop, "kv-plane"),
                             (self._gc_loop, "kv-plane-gc")):
            threading.Thread(target=target, name=name, daemon=True).start()
        log.info("KV plane listening on %s", self.address)

    def _gc_loop(self) -> None:
        # Unclaimed tickets pin their extract's pinned host buffers
        # through their resolvers: drop them after the TTL even when no
        # new stage() comes.
        while not self._closed.wait(min(30.0, STAGED_TTL_S / 4)):
            with self._lock:
                self._gc_locked()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._running = False
        self._closed.set()
        if self._sock is not None:
            try:
                # shutdown() first: a thread blocked in accept() keeps the
                # port listening after close() alone.
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            self._staged.clear()

    # -- staging --------------------------------------------------------------
    def stage(self, kv: np.ndarray | None = None, meta: dict | None = None,
              resolve: Callable[[], np.ndarray] | None = None,
              prompt_len: int | None = None,
              resolve_groups: list | None = None) -> dict:
        """Stage a parcel and return its ticket. Give ``kv`` (a host
        parcel), ``resolve`` (a deferred host fetch, run on the plane's
        thread at pull time) or ``resolve_groups`` ([(n_pages, resolver)]
        page groups along axis 3, sent in order as each resolves); the
        last two need ``meta`` with the parcel's shape and wire dtype."""
        meta = dict(meta or {})
        if kv is not None:
            meta.setdefault("shape", list(kv.shape))
            meta.setdefault("dtype", parcel_dtype_name(kv))
        meta["nbytes"] = int(np.prod(meta["shape"])) \
            * parcel_dtype(meta["dtype"]).itemsize
        if prompt_len is not None:
            meta["prompt_len"] = prompt_len
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._staged[tid] = _Staged(meta, kv, resolve, resolve_groups)
            self._gc_locked()
        return {"id": tid, "addr": self.address, **meta}

    def _gc_locked(self) -> None:
        now = time.monotonic()
        dead = [tid for tid, s in self._staged.items()
                if now - s.t > STAGED_TTL_S]
        for tid in dead:
            del self._staged[tid]
        if dead:
            log.warning("expired %d unclaimed KV transfers", len(dead))

    # -- server loops ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                try:
                    req = _recv_ctrl(conn)
                except (ConnectionError, OSError):
                    return
                op = req.get("op")
                if op == "pull":
                    self._handle_pull(conn, req)
                elif op == "blocks":
                    self._handle_blocks(conn)
                else:
                    _send_ctrl(conn, {"err": f"unknown op {op!r}"})
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_pull(self, conn: socket.socket, req: dict) -> None:
        tid = int(req["id"])
        busy = False
        with self._lock:
            staged = self._staged.get(tid)
            if staged is not None and staged.in_progress:
                staged, busy = None, True
            elif staged is not None:
                staged.in_progress = True
        if staged is None:
            _send_ctrl(conn, {"err": "transfer already in progress" if busy
                              else "unknown or expired transfer id"})
            return
        sent, resolve_err = None, None
        try:
            sent, resolve_err = self._transmit_staged(conn, staged)
        finally:
            # Release the claim BEFORE an error frame goes out: the sink
            # retries the moment it reads the error.
            with self._lock:
                if sent is not None:
                    self._staged.pop(tid, None)
                    self.transfers += 1
                    self.bytes_out += sent
                else:
                    staged.in_progress = False
        if resolve_err is not None:
            _send_ctrl(conn, {"err": resolve_err})

    def _transmit_staged(self, conn: socket.socket,
                         staged: _Staged) -> tuple[int | None, str | None]:
        """Resolve and send one staged parcel: (bytes sent, err). The
        bytes only once every bulk byte is on the wire, else None; ``err``
        is a resolve failure for the caller to report after releasing the
        claim."""
        if staged.groups is not None:
            # Group i rides the wire while group i+1's copy completes.
            try:
                first = np.ascontiguousarray(staged.groups[0][1]())
            except Exception as exc:  # noqa: BLE001
                log.exception("staged KV group resolve failed")
                return None, f"resolve failed: {exc}"
            _send_ctrl(conn, {"ok": True, **staged.meta,
                              "groups": [n for n, _ in staged.groups]})
            sent = first.nbytes
            _send_bulk(conn, first)
            for _, resolver in staged.groups[1:]:
                try:
                    arr = np.ascontiguousarray(resolver())
                except Exception:  # noqa: BLE001
                    # The header went out: only severing the connection
                    # tells the sink that this parcel failed.
                    log.exception("staged KV group resolve failed")
                    conn.shutdown(socket.SHUT_RDWR)
                    return None, None
                _send_bulk(conn, arr)
                sent += arr.nbytes
            return sent, None
        try:
            arr = np.ascontiguousarray(staged.array())
        except Exception as exc:  # noqa: BLE001 — a failed device fetch
            log.exception("staged KV resolve failed")
            return None, f"resolve failed: {exc}"
        _send_ctrl(conn, {"ok": True, **staged.meta})
        _send_bulk(conn, arr)
        return arr.nbytes, None

    def _handle_blocks(self, conn: socket.socket) -> None:
        """G4 remote-tier request: this worker has no block source (the
        host tiers wait for ROADMAP item 9), so none of the hashes is
        held."""
        with self._lock:
            self.block_requests += 1
        _send_ctrl(conn, {"ok": True, "hashes": [], "shape": [],
                          "dtype": "", "nbytes": 0})


class KvPlaneClient:
    """Sink side: pulls staged parcels. Blocking socket I/O runs on
    executor threads; one cached connection per source address, whose
    lock serializes a full request/response cycle."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        self._conns: dict[str, tuple[socket.socket, threading.Lock]] = {}
        self._lock = threading.Lock()
        self.transfers = 0
        self.bytes_in = 0
        self.pull_seconds_total = 0.0
        self.pull_failures = 0
        # Recent pulls: (ticket id, seconds to the answer's header, seconds
        # to its last byte, bytes). The header waits for the source's
        # first page group; the rest is the transfer and any later groups.
        self.recent: collections.deque = collections.deque(maxlen=256)

    def stats(self) -> dict:
        return {"transfers": self.transfers, "bytes_in": self.bytes_in,
                "pull_seconds_total": self.pull_seconds_total,
                "pull_failures": self.pull_failures}

    def _conn_for(self, addr: str) -> tuple[socket.socket, threading.Lock]:
        with self._lock:
            entry = self._conns.get(addr)
        if entry is not None:
            return entry
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=self.timeout)
        sock.settimeout(self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            old = self._conns.get(addr)
            if old is not None:
                sock.close()
                return old
            entry = (sock, threading.Lock())
            self._conns[addr] = entry
        return entry

    def _drop_conn(self, addr: str) -> None:
        with self._lock:
            entry = self._conns.pop(addr, None)
        if entry is not None:
            try:
                entry[0].close()
            except OSError:
                pass

    def pull_sync(self, ticket: dict) -> np.ndarray:
        """Pull a ticket's parcel. Transient failures (a reset mid-
        transfer, a racing pull holding the claim) retry under
        ``policies.KV_PULL``: the parcel stays staged until every byte
        lands. An expired or unknown ticket fails at once."""
        t0 = time.monotonic()
        backoff = Backoff(policies.KV_PULL)
        failed = True
        try:
            while True:
                try:
                    out = self._pull_socket_once(ticket)
                    failed = False
                    return out
                except (ConnectionError, OSError) as exc:
                    if ("expired transfer" in str(exc)
                            or not backoff.sleep_sync()):
                        raise
                    log.warning("KV pull failed (%s); retrying", exc)
        finally:
            with self._lock:
                self.pull_seconds_total += time.monotonic() - t0
                self.pull_failures += failed

    def _pull_socket_once(self, ticket: dict) -> np.ndarray:
        addr = ticket["addr"]
        sock, conn_lock = self._conn_for(addr)
        try:
            with conn_lock:
                t0 = time.perf_counter()
                _send_ctrl(sock, {"op": "pull", "id": int(ticket["id"])})
                resp = _recv_ctrl(sock)
                t_header = time.perf_counter() - t0
                if "err" in resp:
                    raise ConnectionError(f"KV pull refused: {resp['err']}")
                shape = list(resp["shape"])
                dt = parcel_dtype(resp["dtype"])
                out = np.empty(shape, dt)
                if "groups" in resp:
                    # Page groups along axis 3, received in place.
                    off = 0
                    for g in resp["groups"]:
                        view = out[:, :, :, off:off + g]
                        buf = np.empty(view.shape, dt)
                        _recv_bulk_into(sock, memoryview(
                            buf.view(np.uint8).reshape(-1)))
                        view[...] = buf
                        off += g
                else:
                    _recv_bulk_into(sock, memoryview(
                        out.view(np.uint8).reshape(-1)))
                t_end = time.perf_counter() - t0
        except (ConnectionError, OSError, ValueError):
            self._drop_conn(addr)
            raise
        with self._lock:
            self.transfers += 1
            self.bytes_in += out.nbytes
            self.recent.append((int(ticket["id"]), t_header, t_end,
                                out.nbytes))
        return out

    async def pull(self, ticket: dict) -> np.ndarray:
        return await asyncio.get_running_loop().run_in_executor(
            None, self.pull_sync, ticket)

    def close(self) -> None:
        with self._lock:
            conns, self._conns = dict(self._conns), {}
        for sock, _ in conns.values():
            try:
                sock.close()
            except OSError:
                pass
