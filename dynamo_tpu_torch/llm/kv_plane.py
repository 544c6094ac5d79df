"""Direct worker-to-worker KV data plane (counterpart of
``dynamo_tpu.llm.kv_plane``): a socket path between any two workers and
a CUDA IPC device path between two processes on one host.

A prefill worker STAGES a prompt's parcel with its ``KvPlaneServer`` and
sends only a small ticket ``{"id", "addr", "shape", "dtype", "nbytes",
"prompt_len"}`` over the request plane; the decode worker's
``KvPlaneClient`` pulls the bulk bytes. The bytes stay off the request
plane and the coordinator.

Socket path. A control frame is a 4-byte big-endian length and a msgpack
map (``runtime/msgpack_lite.py``); bulk bytes follow raw. ``{"op":
"pull", "id"}`` is answered ``{"ok": true, **meta}`` (with ``"groups":
[pages, ...]`` when the parcel streams as page groups along axis 3) and
the parcel's bytes, or ``{"err"}``; the sink receives into a preallocated
buffer. These are the JAX package's frames, so a port sink pulls from a
JAX source and back; a JAX ticket's ``jax_addr``/``jax_uuid`` (its
``jax.experimental.transfer`` path) are ignored here.

Device path, the port's counterpart of the reference's ``jax`` path. A
server whose probe passes (``CudaIpc.probe``: a CUDA device and an
allocation that torch can export) stages a parcel that is still on the
card (``stage(device_tensor=)``, bf16 only) by exporting its storage, and
the ticket gains one field, ``"cuda_ipc"``: the source's host identity
(hostname and boot id) and pid, the GPU's UUID, the storage's IPC handle,
byte offset and size, and an interprocess event recorded after the
gather. A sink on the same host, in another process, that has not yet
failed a device open from that source address opens the handle on a
stream of its own that waits on the event, copies the parcel into its own
allocation, closes the mapping and sends ``{"op": "done", "id"}``, which
frees the staged tensor (the reference's op). Every other sink, a JAX one
too (it reads only ``jax_addr``), pulls the same ticket over the socket:
the staged entry keeps a resolver that copies the tensor to the host.
Each fall-through is counted (``socket_reasons``) and a failed open is
counted (``device_pull_failures``) and logged, then the ticket goes over
the socket; a same-process pull never takes the device path, because
CUDA does not open a handle in the process that exported it.

A ticket is served exactly once: a concurrent second pull is refused
while the first transmits, and the parcel stays staged until its last
byte is on the wire, so a send that fails leaves it for the sink's retry
(``runtime/retry.py`` ``policies.KV_PULL``). Unclaimed tickets expire
after ``STAGED_TTL_S``; an expired device parcel is released.

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

Each parcel pull records a ``kv.plane.pull`` span, and each G4 consult
that reaches a peer emits a ``kv_peer_pull`` journal event with its
outcome. Not ported: the chaos hooks (ROADMAP item 18).
"""

from __future__ import annotations

import asyncio
import collections
import os
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


def host_identity() -> str:
    """This host as the device path compares it: hostname and boot id
    (two machines, or two boots, never share one)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}/{boot}"


class CudaIpc:
    """The CUDA IPC calls of the device path, behind one small interface:
    torch's storage-sharing calls (the ones ``torch.multiprocessing``
    makes, ``UntypedStorage._share_cuda_`` on the source and
    ``_new_shared_cuda`` on the sink) plus an interprocess event. Tests
    pass an object with the same four methods.

    The handle covers the caching allocator's whole block, so the field
    carries the storage's byte offset in it. torch counts the sink's
    mapping in a shared counter (one at export, back to zero when the
    sink frees its storage); ``release`` takes that count back for an
    export no sink opened, or torch would keep the block in its limbo for
    the life of the process."""

    def __init__(self):
        self._local = threading.local()  # per thread: {device: stream}
        self._uuids: dict[str, int] | None = None

    def probe(self) -> tuple[bool, str]:
        """(usable, why) on the source's side only: a CUDA device, and an
        allocation whose storage exports. Whether a sink can open it shows
        only at the sink's first open (a loopback in one process proves
        nothing: CUDA refuses a handle in its exporting process)."""
        try:
            import torch
            if not torch.cuda.is_available():
                return False, "no CUDA device"
            probe = torch.empty(1 << 21, dtype=torch.uint8, device="cuda")
            self.release(self.export(probe, None))
            return True, (f"a 2 MiB block of {torch.cuda.get_device_name()} "
                          f"exported")
        except Exception as exc:  # noqa: BLE001 — any failure means off
            return False, f"export failed: {type(exc).__name__}: {exc}"

    def export(self, tensor, event) -> dict:
        """The ticket field of a contiguous CUDA tensor: ``event`` (an
        interprocess ``torch.cuda.Event`` recorded after the tensor was
        written) orders the sink's read after the writes."""
        import torch
        if tensor.device.type != "cuda" or not tensor.is_contiguous():
            raise ValueError("the device path exports contiguous CUDA "
                             "tensors only")
        (device, handle, size, offset, ref, ref_offset, share_event,
         share_sync) = tensor.untyped_storage()._share_cuda_()
        return {"host": host_identity(), "pid": os.getpid(),
                "gpu": str(torch.cuda.get_device_properties(device).uuid),
                "device": device, "handle": handle, "size": size,
                "offset": offset, "elem_offset": tensor.storage_offset(),
                "ref": ref, "ref_offset": ref_offset,
                "event": event.ipc_handle() if event is not None else b"",
                "share_event": share_event, "share_sync": share_sync}

    def release(self, field: dict) -> None:
        """Take back the sink's count of an export that no sink holds
        (pulled over the socket, expired, or probed)."""
        import torch
        torch.UntypedStorage._release_ipc_counter(
            field["ref"], field["ref_offset"], device=field["device"])

    def _device_of(self, uuid: str) -> int:
        import torch
        if self._uuids is None:
            self._uuids = {
                str(torch.cuda.get_device_properties(i).uuid): i
                for i in range(torch.cuda.device_count())}
        if uuid not in self._uuids:
            raise RuntimeError(f"GPU {uuid} is not visible to this process")
        return self._uuids[uuid]

    def _stream(self, device: int):
        import torch
        streams = self._local.__dict__.setdefault("streams", {})
        if device not in streams:
            streams[device] = torch.cuda.Stream(device)
        return streams[device]

    def open(self, field: dict, shape, dtype: str):
        """(the parcel in an allocation of this process, seconds to open
        the handle). On the calling thread's own stream (never the
        default stream, where the engine's window graphs replay), which
        waits on the source's event before the copy; the mapping is
        closed before this returns."""
        import torch
        if dtype != "bfloat16":
            raise ValueError(f"device parcels are bf16, not {dtype}")
        device = self._device_of(field["gpu"])
        torch.cuda.set_device(device)
        stream = self._stream(device)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            if field["event"]:
                stream.wait_event(torch.cuda.Event.from_ipc_handle(
                    device, field["event"]))
            storage = torch.UntypedStorage._new_shared_cuda(
                device, field["handle"], field["size"], field["offset"],
                field["ref"], field["ref_offset"], field["share_event"],
                field["share_sync"])
            src = torch.empty(0, dtype=torch.bfloat16, device=device).set_(
                storage, field["elem_offset"], tuple(shape))
            del storage
            open_s = time.perf_counter() - t0
            try:
                out = src.clone()
                stream.synchronize()
            finally:
                # The last reference: the mapping closes here, on this
                # stream, before the source hears "done".
                del src
        return out, open_s


class _Staged:
    __slots__ = ("meta", "payload", "resolve", "groups", "t", "in_progress",
                 "device", "ipc")

    def __init__(self, meta: dict, payload, resolve, groups, device=None,
                 ipc=None):
        self.meta = meta
        self.payload = payload   # host parcel, once known
        self.resolve = resolve   # () -> parcel, or None
        # [(n_pages, () -> parcel of those pages)]: streamed page groups.
        self.groups = groups
        self.t = time.monotonic()
        # Claimed by a pull connection (under the server lock) until its
        # send ends: a second concurrent pull must not also transmit.
        self.in_progress = False
        # The device path: the staged tensor, kept until "done" or the
        # TTL, and its exported field (None when it was not exported).
        self.device = device
        self.ipc = ipc

    def array(self) -> np.ndarray:
        if self.payload is None:
            self.payload = self.resolve()
            self.resolve = None
        return self.payload


class KvPlaneServer:
    """Source side: stages parcels for a direct pull and serves host-tier
    blocks to peers. One per worker process; thread-based, so bulk socket
    I/O never shares the event loop with the request plane.

    ``use_device_path`` (the reference's ``use_jax_path``): None probes
    ``ipc`` at construction; ``device_path`` and ``device_path_reason``
    hold the outcome."""

    def __init__(self, host: str = "127.0.0.1",
                 block_provider: Callable[[int], np.ndarray | None]
                 | None = None, use_device_path: bool | None = None,
                 ipc=None):
        self.host = host
        self.ipc = ipc if ipc is not None else CudaIpc()
        if use_device_path is None:
            self.device_path, self.device_path_reason = self.ipc.probe()
        else:
            self.device_path = use_device_path
            self.device_path_reason = "set by the caller"
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
        self.device_stages = 0          # tickets that carry the field
        self.device_done = 0            # ... whose sink sent "done"
        self.device_export_failures = 0

    def stats(self) -> dict:
        with self._lock:
            staged = len(self._staged)
        return {"transfers": self.transfers, "bytes_out": self.bytes_out,
                "block_requests": self.block_requests,
                "blocks_served": self.blocks_served, "staged": staged,
                "device_path": self.device_path,
                "device_stages": self.device_stages,
                "device_done": self.device_done,
                "device_export_failures": self.device_export_failures,
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
            for staged in self._staged.values():
                self._release(staged)
            self._staged.clear()

    # -- staging --------------------------------------------------------------
    def stage(self, kv: np.ndarray | None = None, meta: dict | None = None,
              resolve: Callable[[], np.ndarray] | None = None,
              prompt_len: int | None = None,
              resolve_groups: list | None = None, device_tensor=None,
              event=None) -> dict:
        """Stage a parcel and return its ticket. Give ``kv`` (a host
        parcel), ``resolve`` (a deferred host fetch, run on the plane's
        thread at pull time) or ``resolve_groups`` ([(n_pages, resolver)]
        page groups along axis 3, sent in order as each resolves); the
        last two need ``meta`` with the parcel's shape and wire dtype.

        ``device_tensor`` (with ``resolve`` for the socket path, and
        ``event``, recorded after the tensor was written) offers the
        device path when this server has it: the tensor is exported on the
        calling thread, stays referenced until the sink's ``done`` or the
        TTL, and the ticket carries ``"cuda_ipc"``. A failed export is
        counted and logged, and the ticket goes out without the field."""
        field = None
        if device_tensor is not None and self.device_path:
            try:
                field = self.ipc.export(device_tensor, event)
            except Exception:  # noqa: BLE001 — counted; the socket remains
                log.exception("device-path export failed; the ticket goes "
                              "over the socket only")
                with self._lock:
                    self.device_export_failures += 1
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
            self._staged[tid] = _Staged(
                meta, kv, resolve, resolve_groups,
                device=device_tensor if field is not None else None,
                ipc=field)
            self.device_stages += field is not None
            self._gc_locked()
        ticket = {"id": tid, "addr": self.address, **meta}
        if field is not None:
            ticket["cuda_ipc"] = field
        return ticket

    def _release(self, staged: _Staged) -> None:
        """Drop a staged entry's device export that no sink holds (called
        under the lock as the entry leaves, except after "done")."""
        if staged.ipc is None:
            return
        try:
            self.ipc.release(staged.ipc)
        except Exception:  # noqa: BLE001 — the block stays in torch's limbo
            log.exception("releasing a device export failed")
        staged.ipc = staged.device = None

    def _gc_locked(self) -> None:
        now = time.monotonic()
        dead = [tid for tid, s in self._staged.items()
                if now - s.t > STAGED_TTL_S]
        for tid in dead:
            self._release(self._staged.pop(tid))
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
                elif op == "done":
                    self._handle_done(req)
                else:
                    _send_ctrl(conn, {"err": f"unknown op {op!r}"})
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_done(self, req: dict) -> None:
        """A sink pulled the ticket over the device path and closed its
        mapping (no answer, as in the reference): free the staged
        tensor now instead of at the TTL."""
        with self._lock:
            staged = self._staged.get(int(req.get("id", -1)))
            if staged is None or staged.in_progress:
                return
            del self._staged[int(req["id"])]
            self.device_done += staged.ipc is not None

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
                    self._release(staged)
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
    """Sink side: pulls staged parcels, over the device path when the
    ticket allows it (a device tensor comes back) and over the socket
    otherwise (a host parcel). Blocking I/O runs on executor threads; one
    cached connection per source address, whose lock serializes a full
    request/response cycle."""

    def __init__(self, timeout: float = 30.0, ipc=None):
        self.timeout = timeout
        self.ipc = ipc if ipc is not None else CudaIpc()
        self._conns: dict[str, tuple[socket.socket, threading.Lock]] = {}
        self._lock = threading.Lock()
        self._host = host_identity()
        self._device_failed: set[str] = set()  # source addresses
        self.transfers = 0
        self.bytes_in = 0
        self.pull_seconds_total = 0.0
        self.pull_failures = 0
        self.device_pulls = 0
        self.device_bytes_in = 0
        self.device_pull_failures = 0
        self.socket_pulls = 0
        # Why a pull went over the socket: {reason: pulls}.
        self.socket_reasons: collections.Counter = collections.Counter()
        # Recent pulls: (ticket id, seconds to the answer's header, seconds
        # to its last byte, bytes, path). Over the socket the header waits
        # for the source's first page group; the rest is the transfer and
        # any later groups. Over the device path the "header" is the
        # handle's open and the rest the copy.
        self.recent: collections.deque = collections.deque(maxlen=256)

    def stats(self) -> dict:
        with self._lock:
            return {"transfers": self.transfers, "bytes_in": self.bytes_in,
                    "pull_seconds_total": self.pull_seconds_total,
                    "pull_failures": self.pull_failures,
                    "device_pulls": self.device_pulls,
                    "device_bytes_in": self.device_bytes_in,
                    "device_pull_failures": self.device_pull_failures,
                    "socket_pulls": self.socket_pulls,
                    "socket_reasons": dict(self.socket_reasons)}

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

    def pull_sync(self, ticket: dict):
        """Pull a ticket's parcel: a CUDA tensor over the device path, or
        a host parcel over the socket. The device path is taken only for a
        ticket with the field, from this host, from another process, whose
        source address has not failed a device open before; a failed open
        is counted, logged and followed by the socket pull of the same
        ticket. Over the socket, transient failures (a reset mid-transfer,
        a racing pull holding the claim) retry under
        ``policies.KV_PULL``: the parcel stays staged until every byte
        lands. An expired or unknown ticket fails at once."""
        t0 = time.monotonic()
        failed = True
        try:
            refusal = self._device_refusal(ticket)
            if refusal is None:
                out = self._pull_device(ticket)
                if out is not None:
                    failed = False
                    return out
                refusal = "the device open failed"
            out = self._pull_socket(ticket, refusal)
            failed = False
            return out
        finally:
            with self._lock:
                self.pull_seconds_total += time.monotonic() - t0
                self.pull_failures += failed

    def _device_refusal(self, ticket: dict) -> str | None:
        """Why this ticket goes over the socket, or None for the device
        path."""
        field = ticket.get("cuda_ipc")
        if not field:
            return "no device field"
        if field.get("host") != self._host:
            return "another host"
        if field.get("pid") == os.getpid():
            return "the source is this process"
        with self._lock:
            if ticket["addr"] in self._device_failed:
                return "a device open from this source failed before"
        return None

    def _pull_device(self, ticket: dict):
        """The device pull (``CudaIpc.open``), then "done" to the source;
        None after a failed open, which is counted and logged, and the
        source remembered."""
        addr, tid = ticket["addr"], int(ticket["id"])
        t0 = time.perf_counter()
        try:
            out, open_s = self.ipc.open(ticket["cuda_ipc"], ticket["shape"],
                                        ticket["dtype"])
        except Exception as exc:  # noqa: BLE001 — counted, logged, socket
            with self._lock:
                self.device_pull_failures += 1
                self._device_failed.add(addr)
            log.warning("device pull of KV ticket %d from %s failed (%s: "
                        "%s); it and later tickets of that source go over "
                        "the socket", tid, addr, type(exc).__name__, exc)
            return None
        t_end = time.perf_counter() - t0
        self._send_done(addr, tid)
        with self._lock:
            self.transfers += 1
            self.device_pulls += 1
            self.bytes_in += out.nbytes
            self.device_bytes_in += out.nbytes
            self.recent.append((tid, open_s, t_end, out.nbytes, "device"))
        return out

    def _send_done(self, addr: str, tid: int) -> None:
        """Tell the source that its staged tensor is no longer needed (no
        answer comes back); if this fails, its TTL frees it."""
        try:
            sock, conn_lock = self._conn_for(addr)
            with conn_lock:
                _send_ctrl(sock, {"op": "done", "id": tid})
        except (ConnectionError, OSError) as exc:
            self._drop_conn(addr)
            log.warning("KV ticket %d: 'done' to %s failed (%s); the source "
                        "frees it at its TTL", tid, addr, exc)

    def _pull_socket(self, ticket: dict, reason: str) -> np.ndarray:
        if reason != "no device field":
            log.info("KV ticket %d goes over the socket: %s",
                     int(ticket["id"]), reason)
        with self._lock:
            self.socket_reasons[reason] += 1
        backoff = Backoff(policies.KV_PULL)
        while True:
            try:
                out = self._pull_socket_once(ticket)
                with self._lock:
                    self.socket_pulls += 1
                return out
            except (ConnectionError, OSError) as exc:
                if ("expired transfer" in str(exc)
                        or not backoff.sleep_sync()):
                    raise
                log.warning("KV pull failed (%s); retrying", exc)

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
                                out.nbytes, "socket"))
        return out

    async def pull(self, ticket: dict):
        from dynamo_tpu_torch.runtime.tracing import span

        with span("kv.plane.pull", ticket=ticket.get("id"),
                  nbytes=ticket.get("nbytes")):
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

    def fetch(self, hashes: list[int], max_blocks: int,
              trace_id: str | None = None) -> list[tuple[int, np.ndarray]]:
        """SYNC (engine thread, between windows): the longest consecutive
        run of the requested blocks that one peer holds, within
        ``budget_s`` of wall clock for the whole consult; from each peer at
        most what ``ask`` allows. Journals each peer's outcome."""
        from dynamo_tpu_torch.runtime import journal
        from dynamo_tpu_torch.runtime.journal import EventKind

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
                # The reference names a chaos injection as the cause; the
                # port has no chaos plane (ROADMAP item 18).
                journal.emit(
                    EventKind.KV_PEER_PULL, trace_id=trace_id,
                    outcome="timeout" if slow else "error", peer=addr,
                    cause=None)
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
                journal.emit(
                    EventKind.KV_PEER_PULL, trace_id=trace_id,
                    outcome="ok", peer=addr, blocks=len(found),
                    nbytes=int(arr.nbytes),
                    cause=journal.recent_ref(EventKind.KV_DEMOTE))
                return [(h, arr[i]) for i, h in enumerate(found)]
        return []
