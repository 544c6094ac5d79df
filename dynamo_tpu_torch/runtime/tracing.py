"""End-to-end request tracing: spans, a ring-buffer recorder, exporters,
the phase histograms and the profiler capture (copy of
``dynamo_tpu.runtime.tracing``, with ``capture_profile`` on
``torch.profiler``).

- ``span(name, ctx=..., **attrs)``: a context manager (sync and async)
  that records start and end times, the parent link (a context variable,
  or an explicit request ``Context``), status (ok, error, cancelled) and
  attributes.
- ``SpanRecorder``: a bounded ring with per-trace assembly and two
  exporters, Chrome trace-event JSON and OTLP-JSON-shaped dicts, byte for
  byte the reference's for the same spans.
- One process-global recorder (``DTPU_TRACING=0`` disables it,
  ``DTPU_TRACE_CAPACITY`` sizes it, default 8192). Disabled, ``span()``
  returns a shared singleton and ``add()`` returns at once: nothing is
  allocated on the per-token path.
- ``phase_metrics(registry)``: the per-phase latency histograms (queue
  wait, prefill, decode, KV transfer) that the span sites also feed.
- ``capture_profile(...)``: the on-demand ``torch.profiler`` capture
  behind ``POST /debug/profile``. It records CPU activity and, where the
  entry point asks for it (a worker whose engine runs on the card), CUDA
  activity; it writes the profiler's Chrome trace and the span ring's
  dump, and counts the device time of each kernel it saw. The session
  starts and stops on the event loop's thread (``prepare_profiler`` pays
  CUPTI's set-up once, at a worker's start); the export and count run
  off it. Where CUDA activity was asked for, a profiler failure is an
  error (``ProfileError``), never a silent fallback to the span dump;
  elsewhere (a frontend) it falls back as the reference does.

Spans are recorded from the event loop and the engine thread; the
recorder takes a lock per span. Engine-thread spans link explicitly
through ``(trace_id, parent_id)`` with ``add``, not context variables.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import json
import os
import re
import threading
import time

from dynamo_tpu_torch.runtime.logging import (current_trace,
                                              generate_span_id,
                                              generate_trace_id, get_logger)

log = get_logger("tracing")

# The active span for the current task/thread (parenting).
current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "dtpu_span", default=None)


class Span:
    """One recorded operation. ``end_mono`` is None while open."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name",
                 "start_wall", "start_mono", "end_mono", "status", "attrs",
                 "thread_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: str | None, name: str,
                 start_wall: float, start_mono: float,
                 attrs: dict | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.name = name
        self.start_wall = start_wall
        self.start_mono = start_mono
        self.end_mono: float | None = None
        self.status = "ok"
        self.attrs = attrs
        self.thread_id = threading.get_ident()

    @property
    def duration_s(self) -> float:
        end = self.end_mono if self.end_mono is not None else self.start_mono
        return end - self.start_mono

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "start_wall": self.start_wall,
            "start_mono": self.start_mono,
            "duration_s": self.duration_s,
            "status": self.status,
            "attrs": self.attrs or {},
        }


class SpanRecorder:
    """Bounded ring buffer of finished spans with per-trace assembly."""

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0  # spans evicted by the ring (observability)

    # -- recording ------------------------------------------------------------
    def record(self, span: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)

    def add(self, name: str, trace_id: str, parent_id: str | None,
            start_mono: float, end_mono: float, status: str = "ok",
            attrs: dict | None = None) -> str | None:
        """Record an already-timed span (engine-thread hot paths measure
        their own intervals; no contextvar juggling). Returns the span id,
        or None when disabled (fast path: one attribute read, no
        allocation)."""
        if not self.enabled:
            return None
        now_mono = time.monotonic()
        span = Span(trace_id=trace_id, span_id=generate_span_id(),
                    parent_span_id=parent_id, name=name,
                    start_wall=time.time() - (now_mono - start_mono),
                    start_mono=start_mono, attrs=attrs)
        span.end_mono = end_mono
        span.status = status
        self.record(span)
        return span.span_id

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- per-trace assembly ---------------------------------------------------
    def trace(self, trace_id: str) -> list[Span]:
        with self._lock:
            spans = [s for s in self._spans if s.trace_id == trace_id]
        spans.sort(key=lambda s: s.start_mono)
        return spans

    def recent(self, limit: int = 50) -> list[dict]:
        """Newest-first index of recorded traces (for /debug/traces/recent)."""
        with self._lock:
            snapshot = list(self._spans)
        by_trace: dict[str, list[Span]] = {}
        for s in snapshot:
            by_trace.setdefault(s.trace_id, []).append(s)
        out = []
        for trace_id, spans in by_trace.items():
            ids = {s.span_id for s in spans}
            roots = [s for s in spans
                     if s.parent_span_id is None
                     or s.parent_span_id not in ids]
            root = min(roots or spans, key=lambda s: s.start_mono)
            t0 = min(s.start_mono for s in spans)
            t1 = max(s.end_mono or s.start_mono for s in spans)
            out.append({
                "trace_id": trace_id,
                "root": root.name,
                "start_wall": root.start_wall,
                "spans": len(spans),
                "duration_s": t1 - t0,
                "status": ("error" if any(s.status == "error" for s in spans)
                           else "ok"),
            })
        out.sort(key=lambda e: e["start_wall"], reverse=True)
        return out[:limit]

    # -- exporters ------------------------------------------------------------
    def export_chrome(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON ("X" complete events, microsecond
        timestamps relative to the earliest span) — drop the payload in
        Perfetto or chrome://tracing."""
        spans = (self.trace(trace_id) if trace_id is not None
                 else sorted(self._snapshot(), key=lambda s: s.start_mono))
        events = []
        if spans:
            base = min(s.start_mono for s in spans)
            pid = os.getpid()
            for s in spans:
                args = dict(s.attrs or {})
                args["trace_id"] = s.trace_id
                args["span_id"] = s.span_id
                if s.parent_span_id:
                    args["parent_span_id"] = s.parent_span_id
                if s.status != "ok":
                    args["status"] = s.status
                events.append({
                    "name": s.name,
                    "ph": "X",
                    "ts": (s.start_mono - base) * 1e6,
                    "dur": s.duration_s * 1e6,
                    "pid": pid,
                    "tid": s.thread_id,
                    "cat": "dtpu",
                    "args": args,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_otlp(self, trace_id: str | None = None) -> dict:
        """OTLP/JSON-shaped dict (ExportTraceServiceRequest): importable
        by any OTLP-JSON consumer without an OTEL SDK dependency."""
        spans = (self.trace(trace_id) if trace_id is not None
                 else sorted(self._snapshot(), key=lambda s: s.start_mono))
        status_code = {"ok": 1, "error": 2, "cancelled": 2}
        otlp_spans = []
        for s in spans:
            start_ns = int(s.start_wall * 1e9)
            otlp_spans.append({
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "parentSpanId": s.parent_span_id or "",
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(start_ns + int(s.duration_s * 1e9)),
                "status": {"code": status_code.get(s.status, 0)},
                "attributes": [
                    {"key": k, "value": _otlp_value(v)}
                    for k, v in (s.attrs or {}).items()
                ],
            })
        return {"resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": "dynamo-tpu"}}]},
            "scopeSpans": [{
                "scope": {"name": "dynamo_tpu.runtime.tracing"},
                "spans": otlp_spans,
            }],
        }]}

    def _snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)


def _otlp_value(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


# -- module-global recorder ----------------------------------------------------

def _env_enabled() -> bool:
    return os.environ.get("DTPU_TRACING", "1").strip().lower() not in (
        "0", "false", "no", "off")


_RECORDER = SpanRecorder(
    capacity=int(os.environ.get("DTPU_TRACE_CAPACITY", "8192") or 8192),
    enabled=_env_enabled())


def get_recorder() -> SpanRecorder:
    return _RECORDER


def set_enabled(flag: bool) -> None:
    _RECORDER.enabled = flag


class _NullSpan:
    """Shared no-op span: the disabled-recorder fast path allocates
    nothing (``span(...)`` returns this singleton)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class span:
    """Record one span around a block. Usable as both ``with span(...)``
    and ``async with span(...)``.

    Parenting: an explicit request ``Context`` pins the span to that
    request's identity (span_id = ctx.span_id, parent = ctx.parent_span_id
    — the ids already propagated on wire frames), otherwise the ambient
    ``current_span`` contextvar parents it; with neither, a new root
    trace starts. While open, the span also publishes itself to
    ``current_trace`` so log lines carry trace_id/span_id.
    """

    __slots__ = ("_name", "_ctx", "_attrs", "_recorder", "_span",
                 "_tok_span", "_tok_trace")

    def __new__(cls, name: str, ctx=None, recorder: SpanRecorder | None = None,
                **attrs):
        rec = recorder if recorder is not None else _RECORDER
        if not rec.enabled:
            return NULL_SPAN
        self = object.__new__(cls)
        self._name = name
        self._ctx = ctx
        self._attrs = attrs or None
        self._recorder = rec
        self._span = None
        self._tok_span = None
        self._tok_trace = None
        return self

    def set(self, **attrs) -> None:
        """Attach attributes to the open span."""
        if self._span is not None:
            if self._span.attrs is None:
                self._span.attrs = {}
            self._span.attrs.update(attrs)

    # -- sync protocol --------------------------------------------------------
    def __enter__(self) -> "span":
        parent = current_span.get()
        if self._ctx is not None:
            trace_id = self._ctx.trace_id
            span_id = self._ctx.span_id
            parent_id = self._ctx.parent_span_id
            if parent is not None and parent.trace_id == trace_id:
                # Nested under an already-open local span of the same
                # trace (e.g. the worker.request span already carries
                # ctx.span_id): parent locally and mint a fresh id so
                # the child never collides with its parent.
                parent_id = parent.span_id
                span_id = generate_span_id()
        elif parent is not None:
            trace_id = parent.trace_id
            span_id = generate_span_id()
            parent_id = parent.span_id
        else:
            trace_id = generate_trace_id()
            span_id = generate_span_id()
            parent_id = None
        s = Span(trace_id=trace_id, span_id=span_id, parent_span_id=parent_id,
                 name=self._name, start_wall=time.time(),
                 start_mono=time.monotonic(), attrs=self._attrs)
        self._span = s
        self._tok_span = current_span.set(s)
        self._tok_trace = current_trace.set(
            {"trace_id": trace_id, "span_id": span_id})
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        s = self._span
        s.end_mono = time.monotonic()
        if exc_type is not None:
            s.status = ("cancelled"
                        if issubclass(exc_type, asyncio.CancelledError)
                        else "error")
            if s.status == "error":
                if s.attrs is None:
                    s.attrs = {}
                s.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        for var, tok in ((current_span, self._tok_span),
                         (current_trace, self._tok_trace)):
            try:
                var.reset(tok)
            except ValueError:
                # Token from another context (generator finalized
                # elsewhere): drop the reset rather than crash cleanup.
                pass
        self._recorder.record(s)
        return False

    # -- async protocol -------------------------------------------------------
    async def __aenter__(self) -> "span":
        return self.__enter__()

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        return self.__exit__(exc_type, exc, tb)


# -- per-phase latency histograms ----------------------------------------------

_LATENCY_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
                    1.0, 2.5, 5.0, 10.0, 30.0)
_BYTES_BUCKETS = (1 << 12, 1 << 16, 1 << 20, 4 << 20, 16 << 20, 64 << 20,
                  256 << 20, 1 << 30)


class PhaseMetrics:
    """The four phase histograms (+ transfer bytes) on a MetricsRegistry
    node. Every constructor touches its hierarchy-labeled child so the
    series appear in /metrics exposition before first traffic."""

    def __init__(self, registry):
        self.queue_wait = registry.histogram(
            "request_queue_wait_seconds",
            "Time a request waited for engine admission",
            buckets=_LATENCY_BUCKETS)
        self.prefill = registry.histogram(
            "prefill_step_seconds",
            "Prefill dispatch to first-token readback",
            buckets=_LATENCY_BUCKETS)
        self.decode = registry.histogram(
            "decode_step_seconds",
            "Decode window dispatch to host processing",
            buckets=_LATENCY_BUCKETS)
        self.kv_transfer = registry.histogram(
            "kv_transfer_seconds",
            "KV parcel transfer (send or recv) duration",
            ["direction"], buckets=_LATENCY_BUCKETS)
        self.kv_transfer_bytes = registry.histogram(
            "kv_transfer_bytes",
            "KV parcel transfer size in bytes",
            ["direction"], buckets=_BYTES_BUCKETS)
        for bound in (self.queue_wait, self.prefill, self.decode):
            bound.ensure()
        for direction in ("send", "recv"):
            self.kv_transfer.ensure(direction=direction)
            self.kv_transfer_bytes.ensure(direction=direction)


def phase_metrics(registry) -> PhaseMetrics:
    """Get-or-create the phase histograms for a registry node (cached on
    the ROOT registry per hierarchy position: node objects are ephemeral
    — ``namespace()``/``component()`` mint a new one per call — so
    repeated wiring of the same position stays idempotent)."""
    root = getattr(registry, "_root", registry)
    cache = getattr(root, "_dtpu_phase_metrics", None)
    if cache is None:
        cache = root._dtpu_phase_metrics = {}
    key = getattr(registry, "_hierarchy", None)
    cached = cache.get(key)
    if cached is None:
        cached = cache[key] = PhaseMetrics(registry)
    return cached


# -- debug endpoint payloads (shared by health.py and http_service.py) --------

def traces_index(recorder: SpanRecorder | None = None,
                 limit: int = 50) -> dict:
    rec = recorder or _RECORDER
    return {"enabled": rec.enabled, "capacity": rec.capacity,
            "dropped": rec.dropped, "traces": rec.recent(limit)}


def trace_payload(trace_id: str, fmt: str = "chrome",
                  recorder: SpanRecorder | None = None) -> dict | None:
    """Export one trace; None when the trace id is unknown."""
    rec = recorder or _RECORDER
    if not rec.trace(trace_id):
        return None
    if fmt == "chrome":
        return rec.export_chrome(trace_id)
    if fmt == "otlp":
        return rec.export_otlp(trace_id)
    if fmt == "spans":
        return {"trace_id": trace_id,
                "spans": [s.to_dict() for s in rec.trace(trace_id)]}
    raise ValueError(f"unknown trace format {fmt!r} "
                     "(expected chrome|otlp|spans)")


# -- on-demand profiler capture ------------------------------------------------

_profile_lock = threading.Lock()  # one capture at a time per process


class ProfileBusyError(RuntimeError):
    """A capture is already running in this process (HTTP 409)."""


class ProfileError(RuntimeError):
    """The profiler failed on a CUDA process (HTTP 500 with the reason)."""


def _activities(cuda: bool) -> list:
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def prepare_profiler() -> float:
    """Run one empty ``torch.profiler`` session with CUDA activity on this
    thread and return its seconds. On the card a process's first session
    spends seconds setting up CUPTI and records nothing; a later one, on
    the same thread, records every kernel, those inside CUDA graph replays
    included. A worker that serves ``/debug/profile`` calls this once on
    its event loop's thread (the thread that loaded torch: a session run
    on another thread recorded no graph kernel), before it connects, so
    the seconds block nothing."""
    import torch
    t0 = time.monotonic()
    prof = torch.profiler.profile(activities=_activities(True))
    prof.start()
    prof.stop()
    return time.monotonic() - t0


_BETWEEN_EVENTS = re.compile(r"[\s,]*")


def _trace_events(text: str):
    """The objects of a Chrome trace's ``traceEvents`` list, decoded one
    at a time: a whole-file ``json.loads`` of a second's trace (150 MB)
    holds the interpreter lock for seconds and stalls the event loop and
    the engine thread; this yields it between events."""
    dec = json.JSONDecoder()
    i = text.index("[", text.index('"traceEvents"')) + 1
    while True:
        i = _BETWEEN_EVENTS.match(text, i).end()
        if i >= len(text) or text[i] == "]":
            return
        evt, i = dec.raw_decode(text, i)
        yield evt


def _count_kernels(prof, out_dir: str, cuda: bool) -> dict:
    """Write a stopped profiler's Chrome trace and count the device
    kernels in it (off the event loop), with the seconds each step
    took."""
    t0 = time.monotonic()
    trace_path = os.path.join(out_dir, "torch.chrome.json")
    prof.export_chrome_trace(trace_path)
    t1 = time.monotonic()
    # Counted from the written trace: the profiler's own per-event Python
    # objects took over a minute for a second's trace.
    with open(trace_path) as fh:
        text = fh.read()
    kernels: dict[str, dict] = {}
    n_events = 0
    for evt in _trace_events(text):
        n_events += 1
        if evt.get("cat") != "kernel":
            continue
        k = kernels.setdefault(evt["name"], {"count": 0, "device_us": 0.0})
        k["count"] += 1
        k["device_us"] += float(evt.get("dur", 0.0))
    if cuda and not kernels:
        raise ProfileError("the profiler recorded no CUDA kernel")
    return {"trace": trace_path,
            "trace_bytes": os.path.getsize(trace_path),
            "trace_events": n_events, "export_s": round(t1 - t0, 3),
            "count_s": round(time.monotonic() - t1, 3), "kernels": kernels}


async def _before_block(hook) -> None:
    """Run ``hook`` (e.g. a lease renewal) before a step that holds the
    event loop or the interpreter lock for seconds; its failure is only
    logged: the capture goes on."""
    if hook is None:
        return
    try:
        await hook()
    except Exception:  # noqa: BLE001 — a courtesy, not a precondition
        log.warning("profile: the hook before a blocking step failed",
                    exc_info=True)


async def _torch_profile(duration_ms: int, out_dir: str, cuda: bool,
                         before_block=None) -> dict:
    """``torch.profiler`` over ``duration_ms``, started and stopped on the
    event loop's thread (see ``prepare_profiler``); the export and the
    count run off it. On a CUDA process the session holds the runner's
    capture lock: a session started during a CUDA graph capture hung the
    process on the card, so a capture waits for the session to end and
    the session for a capture under way. The stop (on the loop) and the
    export (holding the interpreter lock) take seconds each on the card:
    ``before_block`` runs before each, so a worker renews its lease there
    (an unlucky stall of both once outlived the lease, and the worker's
    streams were cut)."""
    import torch

    gate = None
    if cuda:
        from dynamo_tpu_torch.engine.runner import CAPTURE_LOCK as gate
        # Polled, not blocked on: the loop keeps serving meanwhile.
        while not gate.acquire(blocking=False):
            await asyncio.sleep(0.01)
    try:
        prof = torch.profiler.profile(activities=_activities(cuda))
        t0 = time.monotonic()
        prof.start()
        t1 = time.monotonic()
        try:
            await asyncio.sleep(duration_ms / 1e3)
            await _before_block(before_block)
        finally:
            t2 = time.monotonic()
            prof.stop()
        t3 = time.monotonic()
    finally:
        if gate is not None:
            gate.release()
    await _before_block(before_block)
    out = await asyncio.to_thread(_count_kernels, prof, out_dir, cuda)
    return {**out, "start_s": round(t1 - t0, 3), "stop_s": round(t3 - t2, 3)}


async def capture_profile(duration_ms: int, out_dir: str,
                          recorder: SpanRecorder | None = None,
                          cuda: bool = False,
                          before_block=None) -> dict:
    """Capture ``duration_ms`` of activity into ``out_dir``: a
    ``torch.profiler`` trace of CPU and, with ``cuda``, CUDA activity,
    kernels inside CUDA graph replays included, plus the span ring as
    ``spans.chrome.json``. The result has the reference's keys (``mode``
    is ``"torch"``) and, per device kernel name, its count and device
    microseconds, with the trace's bytes and events and the seconds its
    start, stop, export and count took. ``before_block`` (an async
    callable) runs before the stop and before the export, the steps that
    stall the event loop. ``cuda`` is the entry point's choice (a worker
    whose engine runs on the card), never read from the machine: a
    frontend on the card's machine has no kernels to record. Raises
    ``ProfileBusyError`` when a capture is running and, with ``cuda``,
    ``ProfileError`` when the profiler fails or records no kernel; without
    it a failed profiler degrades to the span dump (``mode: "spans"``) as
    the reference does."""
    duration_ms = max(1, min(int(duration_ms), 60_000))
    os.makedirs(out_dir, exist_ok=True)
    if not _profile_lock.acquire(blocking=False):
        raise ProfileBusyError("a profile capture is already running")
    try:
        started = time.monotonic()
        mode = "torch"
        extra: dict = {}
        try:
            extra = await _torch_profile(duration_ms, out_dir, cuda,
                                         before_block)
        except ProfileError:
            raise
        except Exception as exc:  # noqa: BLE001 — typed below
            if cuda:
                raise ProfileError(f"torch.profiler capture failed: "
                                   f"{type(exc).__name__}: {exc}") from exc
            log.warning("torch profiler capture unavailable (%s); "
                        "dumping span recorder instead", exc)
            mode = "spans"
            await asyncio.sleep(duration_ms / 1e3)
        rec = recorder or _RECORDER
        span_path = os.path.join(out_dir, "spans.chrome.json")

        # The ring can hold tens of thousands of spans; serialize and
        # write off the loop, which serves traffic meanwhile.
        def _dump() -> None:
            with open(span_path, "w") as fh:
                json.dump(rec.export_chrome(), fh)

        await asyncio.to_thread(_dump)
        return {"mode": mode, "out_dir": out_dir,
                "span_dump": span_path,
                "duration_ms": duration_ms,
                "wall_s": round(time.monotonic() - started, 3),
                **extra}
    finally:
        _profile_lock.release()
