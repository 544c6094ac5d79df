"""JSONL event recorder and per-request accounting (copy of
``dynamo_tpu.llm.recorder``'s ``Recorder`` and ``RequestLedger``).

``Recorder`` appends events to a JSONL file from a background task:
``record`` enqueues without blocking and drops (and counts) what the sink
cannot keep up with. ``RequestLedger`` keeps one accounting record per
finished request (route, model, adapter, token counts, TTFT, ITL
percentiles, worker id, migrations, status and reason, trace id) in a
bounded ring, served at ``/debug/requests``, with an optional JSONL sink
(``--request-log``, ``DTPU_SLO_REQUEST_LOG_PATH``) on ``Recorder``'s
non-blocking appender; ``finish_account`` also feeds the SLO plane's
availability and goodput SLIs. ``Recorder`` carries the journal's
``DTPU_JOURNAL_PATH`` sink. The stream-recording helpers
of the reference's module (``record_stream``) are copied when a slice
needs them.
"""

from __future__ import annotations

import asyncio
import collections
import json
import threading
import time


class Recorder:
    """JSONL event recorder (recorder.rs:26): events enqueue without
    blocking; a background task appends them to the file, flushing per
    batch. Call ``close`` to drain."""

    def __init__(self, path: str, queue_size: int = 4096):
        self.path = path
        self._q: asyncio.Queue = asyncio.Queue(maxsize=queue_size)
        self._task: asyncio.Task | None = None
        self._closed = False
        self.dropped = 0
        self.written = 0

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run())

    def record(self, event: dict) -> None:
        """Non-blocking enqueue; drops (and counts) when the sink can't
        keep up rather than stalling the serving path."""
        if self._closed:
            return
        try:
            self._q.put_nowait({"ts": time.time(), **event})
        except asyncio.QueueFull:
            self.dropped += 1

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        # open() shares the disk-I/O exile with the writes: on a hung NFS
        # mount even the open can stall the loop for seconds.
        fh = await loop.run_in_executor(None, open, self.path, "a")
        try:
            while True:
                event = await self._q.get()
                stop = event is None
                batch = [] if stop else [event]
                while not self._q.empty():
                    nxt = self._q.get_nowait()
                    if nxt is None:
                        stop = True
                        break
                    batch.append(nxt)
                if batch:
                    # Disk writes off the event loop: a contended disk must
                    # not stall token streaming or lease keepalives.
                    def write_batch(batch=batch):
                        for e in batch:
                            fh.write(json.dumps(e) + "\n")
                        fh.flush()
                    await loop.run_in_executor(None, write_batch)
                    self.written += len(batch)
                if stop:
                    return
        finally:
            await loop.run_in_executor(None, fh.close)

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._task is not None:
            await self._q.put(None)
            await self._task
            self._task = None


# -- per-request accounting ----------------------------------------------------

#: Record statuses. "shed" carries a typed reason from the overload
#: defense (queue_full/deadline/deadline_wait/priority/no_instances);
#: "error" is a genuine failure (5xx); "cancelled" is a client abort.
ACCOUNT_STATUSES = ("ok", "shed", "error", "cancelled")


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * q))]


class RequestLedger:
    """Bounded ring of per-request accounting records + optional JSONL
    sink. ``record()`` is synchronous and non-blocking: the ring append
    happens under a lock, the disk write (when configured) rides the
    ``Recorder`` queue."""

    def __init__(self, capacity: int = 1024, path: str | None = None):
        self.capacity = capacity
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self.counts: collections.Counter = collections.Counter()
        self.total = 0
        self._sink: Recorder | None = Recorder(path) if path else None

    def configure_sink(self, path: str | None) -> None:
        self._sink = Recorder(path) if path else None

    def record(self, rec: dict) -> None:
        status = rec.get("status")
        if status not in ACCOUNT_STATUSES:
            rec["status"] = status = "error"
        with self._lock:
            self._ring.append(rec)
            self.counts[status] += 1
            self.total += 1
        sink = self._sink
        if sink is not None:
            try:
                sink.start()  # idempotent; needs a running loop
            except RuntimeError:
                return  # engine-thread caller with no loop: ring only
            sink.record(rec)

    def recent(self, limit: int = 100) -> list[dict]:
        """Newest-first records for /debug/requests."""
        with self._lock:
            snapshot = list(self._ring)
        return snapshot[::-1][:max(0, limit)]

    def snapshot(self, limit: int = 100) -> dict:
        sink = self._sink
        return {
            "capacity": self.capacity,
            "total": self.total,
            "counts": dict(self.counts),
            "sink": ({"path": sink.path, "written": sink.written,
                      "dropped": sink.dropped} if sink else None),
            "records": self.recent(limit),
        }

    async def close(self) -> None:
        if self._sink is not None:
            await self._sink.close()


def make_account(route: str, model: str, ctx=None) -> dict:
    """A fresh accounting record skeleton. The HTTP layer fills in what
    it learns as the request progresses and hands the result to
    ``finish_account``."""
    return {
        "ts": time.time(),
        "route": route,
        "model": model,
        # LoRA adapter the model name resolved to (None = base model):
        # scripts/slo_report.py --by adapter rolls up per-tenant-model
        # TTFT/ITL/token volumes from this field.
        "adapter": None,
        "request_id": getattr(ctx, "id", None),
        "trace_id": getattr(ctx, "trace_id", None),
        "tenant": None,
        "priority": None,
        "deadline_ms": None,
        "status": None,
        "reason": None,
        "http_status": None,
        "prompt_tokens": None,
        "output_tokens": None,
        "reuse_tokens": None,
        "kv_hit_ratio": None,
        # Which tier served the reuse ({"hbm": n, "host": n, "peer": n}
        # prompt tokens): the "was the cache cold, and where" signal.
        "kv_tiers": None,
        "queue_wait_s": None,
        "ttft_s": None,
        "itl_p50_s": None,
        "itl_p99_s": None,
        "duration_s": None,
        "worker_id": None,
        "migrations": 0,
        "migration_reason": None,
        "brownout_level": 0,
        "_t0": time.monotonic(),   # stripped at finish
        "_itls": [],               # raw gaps; folded to p50/p99 at finish
    }


def finish_account(acct: dict, status: str, reason: str | None = None,
                   http_status: int | None = None, ctx=None,
                   ledger: "RequestLedger | None" = None,
                   slo_plane=None) -> dict:
    """Finalize + ledger a record, and feed the SLO availability/goodput
    SLIs from the same event (one instrumentation point, two consumers)."""
    acct["status"] = status
    acct["reason"] = reason
    acct["http_status"] = http_status
    acct["duration_s"] = time.monotonic() - acct.pop("_t0")
    gaps = sorted(acct.pop("_itls"))
    acct["itl_p50_s"] = _percentile(gaps, 0.50)
    acct["itl_p99_s"] = _percentile(gaps, 0.99)
    if ctx is not None:
        values = getattr(ctx, "values", {})
        for key in ("worker_id", "migrations", "migration_reason",
                    "reuse_tokens", "kv_hit_ratio", "kv_tiers",
                    "queue_wait_s", "adapter"):
            if values.get(key) is not None:
                acct[key] = values[key]
    (ledger or get_ledger()).record(acct)
    if slo_plane is not None:
        slo_plane.observe_request(ok=status == "ok", shed=status == "shed")
    return acct


_LEDGER = RequestLedger()


def get_ledger() -> RequestLedger:
    return _LEDGER


def configure_ledger(capacity: int | None = None,
                     path: str | None = None) -> RequestLedger:
    """Entrypoint wiring (SloConfig.request_ring / request_log_path)."""
    global _LEDGER
    if capacity is not None and capacity != _LEDGER.capacity:
        _LEDGER = RequestLedger(capacity, path)
    elif path is not None:
        _LEDGER.configure_sink(path)
    return _LEDGER
