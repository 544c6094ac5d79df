"""Fleet event journal: the decision plane's typed, causal event log
(copy of ``dynamo_tpu.runtime.journal``).

- A closed ``EventKind`` taxonomy; ``emit()`` rejects unknown kinds.
- Each event carries a process-monotonic ``seq``, wall-clock ``ts``, the
  emitting worker id, the request ``trace_id`` when emitted in a request
  context, and a ``cause`` back-reference (another event's
  ``worker#seq`` ref, or a trace id).
- ``Journal`` is a bounded in-process ring: ``emit()`` takes one lock for
  the append and does no I/O, so the engine thread may call it. The
  optional JSONL sink rides the ``Recorder`` queue (llm/recorder.py).
- ``JournalPublisher`` ships seq-fenced deltas on the namespace's journal
  subject (``ns.<namespace>.journal``) with the reference's payload; the
  frontend's ``TimelineCollector`` (llm/timeline.py) feeds them into
  ``FleetTimeline``, which merges per-worker streams into one timeline
  served at ``GET /debug/timeline``. A changed ``boot`` id or a skipped
  seq range becomes a typed ``journal_gap`` event.

Env knobs (read at configure time): ``DTPU_JOURNAL_CAPACITY`` (ring
slots, default 2048, 0 disables), ``DTPU_JOURNAL_PATH`` (JSONL sink).
"""

from __future__ import annotations

import collections
import os
import threading
import time
import uuid
from typing import Callable

from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("journal")


class EventKind:
    """The closed journal taxonomy (the reference's, value for value: a
    JAX frontend's timeline merges a port worker's events). Emit sites
    use these constants."""

    BREAKER_TRANSITION = "breaker_transition"
    SHED = "shed"
    BROWNOUT_CHANGE = "brownout_change"
    PREEMPT = "preempt"
    MIGRATION = "migration"
    ROLE_FLIP_REQUESTED = "role_flip_requested"
    ROLE_FLIP_DRAINING = "role_flip_draining"
    ROLE_FLIP_DONE = "role_flip_done"
    ROLE_FLIP_REJECTED = "role_flip_rejected"
    SLO_ALERT_FIRE = "slo_alert_fire"
    SLO_ALERT_CLEAR = "slo_alert_clear"
    FLIGHT_BUNDLE = "flight_bundle"
    CHAOS_INJECT = "chaos_inject"
    WORKER_JOIN = "worker_join"
    WORKER_LEAVE = "worker_leave"
    PLANNER_DECISION = "planner_decision"
    CANARY_OK = "canary_ok"
    CANARY_FAIL = "canary_fail"
    # Autoscaling (planner/capacity.py + llm/standby.py): a pre-warmed
    # standby finished its warmup and parked (ready), a scale-out
    # directive promoted it into the serving fleet, and the scale-in
    # retire verb drained a serving worker out of it.
    STANDBY_READY = "standby_ready"
    STANDBY_PROMOTE = "standby_promote"
    SCALE_RETIRE = "scale_retire"
    # KV federation (engine/kvbm.py + llm/kv_plane.py): tier placement
    # decisions — watermark demotions down the ladder, promote-on-hit
    # back up it, and cross-worker block pulls over the KV plane.
    KV_DEMOTE = "kv_demote"
    KV_PROMOTE = "kv_promote"
    KV_PEER_PULL = "kv_peer_pull"
    # Synthesized by the timeline merge, never by emit sites: a worker's
    # delta stream skipped seqs (publisher overflow, dropped frames) or
    # restarted (new boot id).
    JOURNAL_GAP = "journal_gap"


EVENT_KINDS = frozenset(
    v for k, v in vars(EventKind).items() if not k.startswith("_"))


def journal_subject(namespace: str) -> str:
    """The pub/sub subject journal deltas ride (one per namespace: the
    timeline merge wants EVERY component's decisions in one stream)."""
    return f"ns.{namespace}.journal"


def event_ref(worker: str, seq: int) -> str:
    """The globally resolvable identity of one event."""
    return f"{worker}#{seq}"


class Journal:
    """Bounded ring of typed events. Thread-safe: emits come from the
    event loop AND engine threads; ``emit()`` holds the lock only for
    the append (no I/O, no allocation beyond the event dict)."""

    def __init__(self, capacity: int = 2048, worker: str | None = None,
                 metrics=None, clock: Callable[[], float] = time.time):
        self.capacity = max(0, capacity)
        self.enabled = self.capacity > 0
        self.worker = worker or "proc"
        # A fresh id per Journal instance: consumers detect a worker
        # restart (seq reset) by the boot change, not by guessing.
        self.boot = uuid.uuid4().hex[:8]
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=self.capacity or 1)
        self._seq = 0
        self.emitted_total = 0
        # Events evicted from the ring before any publisher shipped them
        # (JournalPublisher.flush detects the seq hole and adds here).
        self.dropped_overflow = 0
        # kind -> (seq, ref) of the newest event of that kind, for
        # cause attribution by downstream emit sites.
        self._recent: dict[str, tuple[int, str]] = {}
        self._sink = None
        self._m_events = self._m_dropped = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        m = metrics.namespace("journal")
        self._m_events = m.counter(
            "journal_events_total", "Fleet journal events emitted",
            ["kind"])
        self._m_dropped = m.counter(
            "journal_dropped_total",
            "Journal events lost to ring overflow before publication")

    def configure_sink(self, path: str | None) -> None:
        """Optional durable JSONL sink (non-blocking Recorder queue)."""
        if path:
            from dynamo_tpu_torch.llm.recorder import Recorder
            self._sink = Recorder(path)
        else:
            self._sink = None

    # -- emit ------------------------------------------------------------------
    def emit(self, kind: str, *, cause: str | None = None,
             trace_id: str | None = None, worker: str | None = None,
             **attrs) -> str:
        """Record one typed event; returns its ``worker#seq`` ref (the
        handle a downstream emitter passes as its own ``cause``).
        Unknown kinds are a bug at the call site: ValueError."""
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown journal event kind {kind!r} (use the EventKind "
                "constants from runtime/journal.py)")
        origin = worker or self.worker
        with self._lock:
            self._seq += 1
            seq = self._seq
            ref = event_ref(origin, seq)
            event = {"kind": kind, "seq": seq, "ts": self._clock(),
                     "worker": origin, "ref": ref, "trace_id": trace_id,
                     "cause": cause, "attrs": attrs}
            if self.enabled:
                self._ring.append(event)
            self._recent[kind] = (seq, ref)
            self.emitted_total += 1
        if self._m_events is not None:
            self._m_events.inc(kind=kind)
        sink = self._sink
        if sink is not None:
            try:
                sink.start()  # idempotent; needs a running loop
            except RuntimeError:
                pass  # engine-thread caller with no loop: ring only
            else:
                sink.record(event)
        return ref

    def recent_ref(self, *kinds: str) -> str | None:
        """The ref of the newest event among ``kinds`` — how an emit
        site names its most plausible upstream cause without threading
        refs through every call path."""
        best: tuple[int, str] | None = None
        with self._lock:
            for kind in kinds:
                entry = self._recent.get(kind)
                if entry is not None and (best is None or entry[0] > best[0]):
                    best = entry
        return best[1] if best else None

    # -- read ------------------------------------------------------------------
    def since(self, last_seq: int) -> tuple[list[dict], int]:
        """(events with seq > last_seq oldest-first, missed count).
        ``missed`` > 0 means the ring already evicted events the caller
        never saw — the publisher reports it so the timeline can mark a
        typed gap instead of silently skipping."""
        with self._lock:
            events = [e for e in self._ring if e["seq"] > last_seq]
            missed = 0
            if events:
                missed = events[0]["seq"] - last_seq - 1
            elif self._seq > last_seq:
                missed = self._seq - last_seq
            return events, max(0, missed)

    def note_dropped(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.dropped_overflow += n
        if self._m_dropped is not None:
            self._m_dropped.inc(n)

    @property
    def seq(self) -> int:
        return self._seq

    def events(self, limit: int = 0) -> list[dict]:
        """Ring contents oldest-first (the newest ``limit`` when set)."""
        with self._lock:
            rows = list(self._ring)
        return rows[-limit:] if limit > 0 else rows

    def snapshot(self, limit: int = 512) -> dict:
        return {
            "worker": self.worker,
            "boot": self.boot,
            "enabled": self.enabled,
            "capacity": self.capacity,
            "seq": self._seq,
            "emitted_total": self.emitted_total,
            "dropped_overflow": self.dropped_overflow,
            "events": self.events(limit),
        }

    async def close(self) -> None:
        if self._sink is not None:
            await self._sink.close()


# -- process-global journal ----------------------------------------------------

def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


_JOURNAL = Journal(capacity=_env_int("DTPU_JOURNAL_CAPACITY", 2048))


def get_journal() -> Journal:
    return _JOURNAL


def configure(worker: str | None = None, metrics=None,
              capacity: int | None = None,
              path: str | None = None) -> Journal:
    """Entrypoint wiring (worker mains, frontend, launcher): the worker
    identity events are attributed to, the metrics registry, and the
    optional JSONL sink. The ring (and its seq fence) is preserved
    unless capacity changes."""
    global _JOURNAL
    if capacity is not None and capacity != _JOURNAL.capacity:
        _JOURNAL = Journal(capacity=capacity, worker=worker or _JOURNAL.worker)
    if worker is not None:
        _JOURNAL.worker = worker
    if metrics is not None:
        _JOURNAL.bind_metrics(metrics)
    if path is None:
        path = os.environ.get("DTPU_JOURNAL_PATH") or None
    if path:
        _JOURNAL.configure_sink(path)
    return _JOURNAL


def emit(kind: str, *, cause: str | None = None, trace_id: str | None = None,
         worker: str | None = None, **attrs) -> str:
    """Module-level emit on the process journal (the form every
    instrumented subsystem uses: ``journal.emit(EventKind.X, ...)``)."""
    return _JOURNAL.emit(kind, cause=cause, trace_id=trace_id,
                         worker=worker, **attrs)


def recent_ref(*kinds: str) -> str | None:
    return _JOURNAL.recent_ref(*kinds)


# -- event-plane delta publisher ----------------------------------------------


class JournalPublisher:
    """Ships journal deltas on the event plane, seq-fenced (same shape
    as ``KvInventoryPublisher``): each message carries the worker id,
    the journal's ``boot``, the covered seq range, and any ``overflow``
    (events the ring evicted before this flush — the consumer marks a
    typed gap). ``client`` is anything with ``publish(subject, dict)``
    (a coordinator client); the planner passes its raw client."""

    def __init__(self, client, namespace: str, worker: str,
                 journal: Journal | None = None,
                 min_interval_s: float = 0.5, max_batch: int = 256):
        self._client = client
        self.subject = journal_subject(namespace)
        self.worker = worker
        self._journal = journal or get_journal()
        self.min_interval_s = min_interval_s
        self.max_batch = max_batch
        self._last_seq = 0
        self.published = 0
        self._periodic = None

    async def flush(self, force: bool = False) -> int:
        """Publish everything emitted since the last flush. Returns the
        number of events shipped."""
        journal = self._journal
        events, missed = journal.since(self._last_seq)
        if missed:
            journal.note_dropped(missed)
        if not events and not (force or missed):
            return 0
        shipped = 0
        while True:
            batch = events[:self.max_batch]
            events = events[self.max_batch:]
            payload = {
                "worker": self.worker,
                "boot": journal.boot,
                "first_seq": batch[0]["seq"] if batch else self._last_seq + 1,
                "last_seq": batch[-1]["seq"] if batch else self._last_seq,
                "overflow": missed,
                "events": batch,
            }
            await self._client.publish(self.subject, payload)
            self.published += 1
            shipped += len(batch)
            if batch:
                self._last_seq = batch[-1]["seq"]
            elif missed:
                # Everything in the hole was already evicted: advance
                # the fence past it or every flush re-reports the miss.
                self._last_seq += missed
            missed = 0  # reported once
            if not events:
                return shipped

    def start_periodic(self) -> None:
        import asyncio

        async def loop() -> None:
            while True:
                await asyncio.sleep(self.min_interval_s)
                try:
                    await self.flush()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — telemetry, keep going
                    log.exception("journal delta publish failed")

        if self._periodic is None:
            self._periodic = asyncio.get_running_loop().create_task(loop())

    def stop_periodic(self) -> None:
        if self._periodic is not None:
            self._periodic.cancel()
            self._periodic = None


# -- fleet timeline merge ------------------------------------------------------


class FleetTimeline:
    """Merges per-worker journal delta streams into one causally
    ordered fleet timeline (sync core; the subscription loop lives in
    llm/timeline.py, same split as ``FleetInventory``).

    Fencing: per-worker ``(boot, last_seq)``. A delta with seqs at or
    below the fence is a replay/reorder and is dropped; a delta whose
    ``boot`` changed means the worker restarted — the fence resets and
    a typed ``journal_gap`` event marks the discontinuity instead of
    the old fence silently swallowing the fresh stream. A skipped seq
    range (publisher overflow, dropped frames) likewise becomes a
    ``journal_gap``. ``ApproxKvIndexer``-style staleness: stream state
    for a worker that stops publishing is pruned after ``ttl_s`` (its
    already-merged events stay — they are history)."""

    def __init__(self, ttl_s: float = 60.0, capacity: int = 8192,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time):
        self.ttl_s = ttl_s
        self._clock = clock
        self._wall = wall_clock
        # worker -> {"boot", "last_seq", "rx_t"}
        self._streams: dict[str, dict] = {}
        self._events: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        self._gap_seq = 0
        self.applied = 0
        self.dropped_stale_seq = 0
        self.gaps = 0

    def _gap(self, worker: str, reason: str, **attrs) -> None:
        """Synthesize a typed journal_gap event in the merged stream
        (gaps get their own 'timeline' worker namespace so their refs
        can't collide with real worker seqs)."""
        self._gap_seq += 1
        self.gaps += 1
        self._events.append({
            "kind": EventKind.JOURNAL_GAP,
            "seq": self._gap_seq,
            "ts": self._wall(),
            "worker": "timeline",
            "ref": event_ref("timeline", self._gap_seq),
            "trace_id": None,
            "cause": None,
            "attrs": {"stream": worker, "reason": reason, **attrs},
        })

    def apply_delta(self, payload: dict) -> int:
        """Apply one publisher message; returns events merged."""
        worker = str(payload.get("worker") or "?")
        boot = str(payload.get("boot") or "")
        events = payload.get("events") or []
        stream = self._streams.get(worker)
        if stream is None:
            stream = self._streams[worker] = {
                "boot": boot, "last_seq": 0, "rx_t": self._clock()}
        elif boot and stream["boot"] != boot:
            # Restart: seqs reset. Without this reset the old fence
            # would silently drop (reorder) the entire fresh stream.
            self._gap(worker, "restart", old_boot=stream["boot"],
                      new_boot=boot)
            stream["boot"] = boot
            stream["last_seq"] = 0
        stream["rx_t"] = self._clock()
        overflow = int(payload.get("overflow") or 0)
        first = int(payload.get("first_seq") or 0)
        if overflow or (first and first > stream["last_seq"] + 1):
            missing = max(overflow, first - stream["last_seq"] - 1)
            self._gap(worker, "missed", missing=missing,
                      resume_seq=first)
        applied = 0
        for event in events:
            seq = int(event.get("seq") or 0)
            if seq <= stream["last_seq"]:
                self.dropped_stale_seq += 1
                continue
            stream["last_seq"] = seq
            row = dict(event)
            row.setdefault("worker", worker)
            row.setdefault("ref", event_ref(worker, seq))
            self._events.append(row)
            applied += 1
        self.applied += applied
        return applied

    def prune(self) -> list[str]:
        """Drop stream fences not heard from within ttl_s (deregistered
        or dead workers). Their merged events remain."""
        now = self._clock()
        dead = [w for w, s in self._streams.items()
                if now - s["rx_t"] > self.ttl_s]
        for w in dead:
            del self._streams[w]
        return dead

    def events(self, limit: int = 0) -> list[dict]:
        rows = sorted(self._events, key=lambda e: e["ts"])
        return rows[-limit:] if limit > 0 else rows

    def snapshot(self, limit: int = 512) -> dict:
        now = self._clock()
        return {
            "workers": {
                w: {"boot": s["boot"], "last_seq": s["last_seq"],
                    "age_s": round(now - s["rx_t"], 3),
                    "stale": now - s["rx_t"] > self.ttl_s}
                for w, s in sorted(self._streams.items())},
            "applied": self.applied,
            "dropped_stale_seq": self.dropped_stale_seq,
            "gaps": self.gaps,
            "events": self.events(limit),
        }


def merge_timeline(fleet_events: list[dict], local: Journal | None = None,
                   limit: int = 512) -> list[dict]:
    """One causally ordered stream: the fleet's merged events plus this
    process's own journal (the frontend emits sheds/breaker/SLO events
    locally — they never ride the event plane)."""
    rows = list(fleet_events)
    if local is not None:
        rows.extend(local.events())
    rows.sort(key=lambda e: e["ts"])
    return rows[-limit:] if limit > 0 else rows
