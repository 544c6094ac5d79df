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
after ``STAGED_TTL_S``.

The same socket serves ``{"op": "blocks", "hashes", "max"}``: the G4
remote tier, where peers fetch KV blocks from this worker's host tiers by
block hash (``block_provider``, the engine's ``host_cache.get``). The
answer is the longest run of the requested hashes held, stopping at the
first miss, as ``{"ok", "hashes", "shape", "dtype", "nbytes"}`` and the
stacked blocks [n, 2, L, Nkv, page, D]; bf16 blocks travel labelled
``"bfloat16"``, so JAX and port workers read each other's.
``RemoteBlockSource`` is the consulting side: one wall-clock budget for a
whole consult, a breaker per peer. Unlike the reference, it asks a peer
(through ``max``) for only as many blocks as its share of the budget
carries at the rate that peer last delivered, so a prefix too long for
one budget still brings its head instead of timing out whole; the wire
is unchanged.

Not ported: the same-host device path and the chaos hooks (ROADMAP items
8 and 18).
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


def _recv_bulk_into(sock: socket.socket, buf: memoryview,
                    deadline: float | None = None) -> None:
    """Fill ``buf`` from the socket. ``deadline`` (a time.monotonic value)
    bounds the whole payload, not each recv: a per-recv timeout restarts
    with every segment, so a trickling peer could stretch a transfer
    without ever tripping it."""
    got, n = 0, len(buf)
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(
                    f"bulk recv deadline exceeded ({got}/{n} bytes)")
            sock.settimeout(remaining)
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
    """Source side: stages parcels for a direct pull and serves host-tier
    blocks to peers. One per worker process; thread-based, so bulk socket
    I/O never shares the event loop with the request plane."""

    def __init__(self, host: str = "127.0.0.1",
                 block_provider: Callable[[int], np.ndarray | None]
                 | None = None):
        self.host = host
        self.port = 0
        self.block_provider = block_provider
        self._staged: dict[int, _Staged] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._running = False
        self._closed = threading.Event()  # wakes the GC thread on close
        self.transfers = 0
        self.bytes_out = 0
        self.block_requests = 0
        self.blocks_served = 0

    def stats(self) -> dict:
        with self._lock:
            staged = len(self._staged)
        return {"transfers": self.transfers, "bytes_out": self.bytes_out,
                "block_requests": self.block_requests,
                "blocks_served": self.blocks_served, "staged": staged,
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
                    self._handle_blocks(conn, req)
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

    def _handle_blocks(self, conn: socket.socket, req: dict) -> None:
        """G4 remote-tier request: which of the requested block hashes this
        worker's host tiers hold, with their bytes, stopping at the first
        miss (later blocks are useless without the earlier ones)."""
        with self._lock:
            self.block_requests += 1
        provider = self.block_provider
        found: list[np.ndarray] = []
        found_hashes: list[int] = []
        if provider is not None:
            limit = int(req.get("max", 64))
            for h in [int(h) for h in req.get("hashes", [])][:limit]:
                kv = provider(h)
                if kv is None:
                    break
                found.append(kv)
                found_hashes.append(h)
        if not found:
            _send_ctrl(conn, {"ok": True, "hashes": [], "shape": [],
                              "dtype": "", "nbytes": 0})
            return
        stacked = np.stack(found)  # [n, 2, L, Nkv, page, D]
        _send_ctrl(conn, {"ok": True, "hashes": found_hashes,
                          "shape": list(stacked.shape),
                          "dtype": parcel_dtype_name(stacked),
                          "nbytes": stacked.nbytes})
        _send_bulk(conn, stacked)
        with self._lock:
            self.blocks_served += len(found)


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

    def fetch_blocks_sync(self, addr: str, hashes: list[int],
                          max_blocks: int = 64,
                          timeout: float | None = None
                          ) -> tuple[list[int], np.ndarray | None]:
        """G4: ask a peer for a consecutive run of block hashes from its
        host tiers. Returns (hashes found, [n, 2, L, Nkv, page, D]).
        ``timeout`` bounds this whole request and answer (the consult's
        overall budget is the caller's)."""
        sock, conn_lock = self._conn_for(addr)
        deadline = (time.monotonic() + timeout if timeout is not None
                    else None)
        try:
            with conn_lock:
                if timeout is not None:
                    sock.settimeout(max(0.01, timeout))
                _send_ctrl(sock, {"op": "blocks", "hashes": hashes,
                                  "max": max_blocks})
                resp = _recv_ctrl(sock)
                if "err" in resp:
                    raise ConnectionError(
                        f"block fetch refused: {resp['err']}")
                if not resp["hashes"]:
                    if timeout is not None:
                        sock.settimeout(self.timeout)
                    return [], None
                dt = parcel_dtype(resp["dtype"])
                buf = np.empty(int(resp["nbytes"]), np.uint8)
                _recv_bulk_into(sock, memoryview(buf), deadline=deadline)
                if timeout is not None:
                    sock.settimeout(self.timeout)
        except (ConnectionError, OSError, ValueError):
            self._drop_conn(addr)
            raise
        with self._lock:
            self.bytes_in += buf.nbytes
        return list(resp["hashes"]), buf.view(dt).reshape(resp["shape"])

    def close(self) -> None:
        with self._lock:
            conns, self._conns = dict(self._conns), {}
        for sock, _ in conns.values():
            try:
                sock.close()
            except OSError:
                pass


class RemoteBlockSource:
    """G4 remote tier: KV blocks from peer workers' host tiers by block
    hash. The engine's KVBM consults it when a prefix extension misses the
    local tiers: one bounded round trip per peer, first hit wins.
    Content-hashed blocks make the answer trustworthy whichever worker
    computed them.

    ``peers`` is replaced whole by the worker's watch of ``kvplane/``
    registrations, so the engine thread only ever reads a consistent
    list. A failing peer's breaker opens for a cooldown that walks
    ``policies.G4_PEER_BREAKER``: successive failures back off
    exponentially, the consult after a cooldown is the half-open probe,
    and one success resets the curve."""

    # G4 fetches run on the engine thread between windows: the whole
    # consult, every peer together, gets one budget below a window period,
    # so neither a dead peer nor a slow one stalls the decode streams for
    # longer. Recomputing the prefix is always the safe fallback.
    G4_BUDGET_S = 0.1
    MAX_PEERS = 4  # peers consulted per fetch, in list order
    # A consult asks a peer for the blocks that BUDGET_FILL of the time
    # left carries at that peer's seconds a block, measured over its last
    # answers (a slowdown counts at once, a speedup half). Fixed costs
    # make small answers look slow a block, so the ask grows back until
    # one answer takes BUDGET_FILL of the budget. Before a peer has
    # answered, a block of ``block_nbytes`` is taken to move at
    # FIRST_RATE_BPS; with ``block_nbytes`` unknown (0) the first ask is
    # the whole run, as in the reference.
    BUDGET_FILL = 0.5
    FIRST_RATE_BPS = 0.1e9

    def __init__(self, self_addr: str | None = None,
                 budget_s: float | None = None, block_nbytes: int = 0):
        self.budget_s = self.G4_BUDGET_S if budget_s is None else budget_s
        self.block_nbytes = block_nbytes
        self._s_per_block: dict[str, float] = {}  # addr -> measured
        self.client = KvPlaneClient(timeout=self.budget_s)
        self.self_addr = self_addr
        self.peers: list[str] = []
        self.breaker_policy = policies.G4_PEER_BREAKER
        self._cooldown: dict[str, float] = {}  # addr -> half-open time
        self._fail_streak: dict[str, int] = {}  # addr -> curve position
        self.fetched_blocks = 0
        self.fetch_failures = 0
        self.slow_peer_cooldowns = 0
        self.breaker_open_skips = 0   # consults skipped on open breakers

    def stats(self) -> dict:
        now = time.monotonic()
        return {"peers": len(self.peers),
                "fetched_blocks": self.fetched_blocks,
                "fetch_failures": self.fetch_failures,
                "slow_peer_cooldowns": self.slow_peer_cooldowns,
                "breaker_open_skips": self.breaker_open_skips,
                "breakers_open": sum(1 for t in self._cooldown.values()
                                     if t > now),
                **{f"client_{k}": v for k, v in self.client.stats().items()}}

    def _open_breaker(self, addr: str, reason: str) -> None:
        """One more failure on this peer: advance its breaker curve and
        cool it down for the policy's delay at that position."""
        streak = self._fail_streak.get(addr, 0)
        delay = self.breaker_policy.delay(streak)
        self._fail_streak[addr] = streak + 1
        self._cooldown[addr] = time.monotonic() + delay
        log.warning("G4 peer %s %s; breaker open %.1fs (streak %d)",
                    addr, reason, delay, streak + 1)

    def _note_success(self, addr: str) -> None:
        self._cooldown.pop(addr, None)
        self._fail_streak.pop(addr, None)

    def drop_peer(self, addr: str) -> None:
        """Forget a peer that left the fleet: its address leaves the
        consult list and its breaker state goes with it, so a worker that
        later rejoins on the same address starts with a closed breaker."""
        self.peers = [a for a in self.peers if a != addr]
        self._cooldown.pop(addr, None)
        self._fail_streak.pop(addr, None)
        self._s_per_block.pop(addr, None)

    def ask(self, addr: str, remaining: float, wanted: int) -> int:
        """How many of ``wanted`` blocks to ask ``addr`` for with
        ``remaining`` seconds of the consult's budget left."""
        s = self._s_per_block.get(addr)
        if s is None:
            if not self.block_nbytes:
                return wanted
            s = self.block_nbytes / self.FIRST_RATE_BPS
        return max(1, min(wanted, int(remaining * self.BUDGET_FILL / s)))

    def _note_rate(self, addr: str, seconds: float, blocks: int) -> None:
        s = seconds / blocks
        old = self._s_per_block.get(addr)
        self._s_per_block[addr] = s if old is None or s > old \
            else (old + s) / 2

    def fetch(self, hashes: list[int],
              max_blocks: int) -> list[tuple[int, np.ndarray]]:
        """SYNC (engine thread, between windows): the longest consecutive
        run of the requested blocks that one peer holds, within
        ``budget_s`` of wall clock for the whole consult; from each peer at
        most what ``ask`` allows."""
        deadline = time.monotonic() + self.budget_s
        for addr in list(self.peers)[:self.MAX_PEERS]:
            if addr == self.self_addr or not addr:
                continue
            now = time.monotonic()
            remaining = deadline - now
            if remaining <= 0:
                break
            if self._cooldown.get(addr, 0.0) > now:
                self.breaker_open_skips += 1
                continue
            n = self.ask(addr, remaining, min(max_blocks, len(hashes)))
            try:
                found, arr = self.client.fetch_blocks_sync(
                    addr, hashes[:n], n, timeout=remaining)
            except (ConnectionError, OSError) as exc:
                self.fetch_failures += 1
                slow = isinstance(exc, (socket.timeout, TimeoutError))
                if slow:
                    self.slow_peer_cooldowns += 1
                self._open_breaker(addr,
                                   "too slow" if slow else "unreachable")
                continue
            took = time.monotonic() - now
            if took > self.budget_s:
                # Answered, but ate the whole budget: treat it as slow and
                # stop consulting it for a while.
                self.slow_peer_cooldowns += 1
                self._open_breaker(addr, "consult overran budget")
            else:
                self._note_success(addr)
            if found:
                self._note_rate(addr, took, len(found))
                self.fetched_blocks += len(found)
                return [(h, arr[i]) for i, h in enumerate(found)]
        return []
