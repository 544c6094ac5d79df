"""Overload defense: adaptive admission, deadline-aware shedding,
priority classes, per-worker circuit breakers, and brownout degradation.

The reference Dynamo treats overload as an SLA-governed, planner-managed
condition (WorkerMonitor busy detection + planner scaling); this module is
the in-process half of that story — what a frontend does in the seconds
before new capacity exists. Four cooperating pieces:

- ``AdaptiveLimiter`` — an AIMD concurrency limiter wrapped around
  frontend request handling. The limit grows additively while observed
  per-phase latency (TTFT for streaming) stays under
  ``target_latency_ms`` and shrinks multiplicatively when it doesn't,
  so admitted requests stay fast no matter the offered load. Excess
  arrivals wait in a bounded queue; everything past the bound is shed
  with a typed, retryable 503.

- **Deadline-aware shedding** — a request carrying a client deadline
  (``x-request-deadline-ms``, or the server default) is rejected the
  moment the admission-queue projection says the deadline cannot be
  met, instead of timing out after consuming a slot. Deadline sheds are
  client-pacing rejections (``RateLimitedError`` → HTTP 429): retrying
  immediately with the same deadline cannot succeed.

- **Priority classes** — ``interactive`` sheds last and is granted
  queued slots first; ``batch`` sheds outright once pressure reaches
  ``batch_shed_level`` and can never starve interactive waiters.

- ``CircuitBreaker`` / ``BreakerBoard`` — per-worker failure tracking
  in the router/client path. Consecutive typed failures or latency
  outliers open the breaker; the scheduler excludes that instance;
  after ``breaker_cooldown_s`` a half-open probe re-admits it.

Brownout: ``pressure_level()`` (0..3) drives degradation hooks — batch
shedding, ``clamp_max_tokens`` — and is reported to clients in the
``X-Overload-Brownout`` response header. The TPU engine runs its own
engine-local brownout off its TTFT projection (engine/engine.py).

Determinism: nothing here reads a wall clock it wasn't given (``clock``
is injectable) and the only RNG (Retry-After jitter, which de-syncs
client retry herds) is seeded from ``OverloadConfig.seed`` — the unit
matrix in tests/test_overload.py drives everything from a fake clock.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import random
import time
from typing import Callable, Iterable

from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.errors import OverloadedError, RateLimitedError
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("overload")

#: Journal throttle for shed events: an overload storm sheds thousands
#: of requests per second — the decision plane wants one event per
#: (reason, priority) per interval with a suppressed count, not all of
#: them (the shed_total counter keeps the exact tally).
_SHED_JOURNAL_INTERVAL_S = 1.0

PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BATCH = "batch"
PRIORITIES = (PRIORITY_INTERACTIVE, PRIORITY_BATCH)

# Breaker states (exposed via BreakerBoard.state for metrics/tests).
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclasses.dataclass
class OverloadConfig:
    """Knobs for the whole defense stack. All plain scalars so the
    generic DTPU_OVERLOAD_* env override in runtime/config.py can map
    them 1:1 (0 = disabled where a feature is optional)."""

    enabled: bool = True

    # -- adaptive admission (AIMD on observed latency vs. target) ------------
    # Per-phase latency target the limit adapts against: time from
    # admission to first token for streaming routes.
    target_latency_ms: float = 5000.0
    min_concurrency: int = 1
    max_concurrency: int = 512
    initial_concurrency: int = 16
    # Classic AIMD: +additive/limit per under-target completion (≈ +additive
    # per RTT), ×multiplicative on an over-target completion, at most one
    # decrease per decrease_cooldown_s so a burst of stale completions
    # can't collapse the limit to the floor in one tick.
    additive_increase: float = 1.0
    multiplicative_decrease: float = 0.7
    decrease_cooldown_s: float = 1.0
    # Bounded admission wait queue (all priorities combined).
    queue_depth: int = 64
    # Server default when the client sends no x-request-deadline-ms.
    default_deadline_ms: float = 30_000.0

    # -- priority / brownout --------------------------------------------------
    # pressure_level() thresholds: level1 = saturated, level2/3 = queue
    # filling. pressure = inflight/limit while the queue is empty, else
    # 1 + waiting/queue_depth.
    level1_pressure: float = 0.95
    level2_pressure: float = 1.25
    level3_pressure: float = 1.75
    # Batch traffic sheds outright at this pressure level (interactive
    # only sheds via queue bound / deadline projection).
    batch_shed_level: int = 2
    # Brownout degradation: at >= clamp level, responses are clamped to
    # brownout_max_tokens (0 disables clamping).
    brownout_clamp_level: int = 2
    brownout_max_tokens: int = 0

    # -- Retry-After derivation ----------------------------------------------
    # Fallback when the limiter has no calibrated service time yet (and
    # the config default the HTTP layer uses for non-limiter 503s).
    retry_after_default_s: float = 1.0
    retry_after_max_s: float = 30.0

    # -- per-worker circuit breakers -----------------------------------------
    breaker_enabled: bool = True
    breaker_failures: int = 5        # consecutive failures/outliers to open
    breaker_cooldown_s: float = 5.0  # open -> half-open probe delay
    # A completion slower than factor x the worker's EWMA latency counts
    # as an outlier failure (only once min_samples calibrated the EWMA).
    breaker_latency_factor: float = 5.0
    breaker_min_samples: int = 20

    # Seeds the Retry-After jitter stream (the only randomness here).
    seed: int = 0


# -- adaptive admission -------------------------------------------------------


class _Waiter:
    __slots__ = ("fut", "priority", "enqueued_t")

    def __init__(self, fut: asyncio.Future, priority: str, enqueued_t: float):
        self.fut = fut
        self.priority = priority
        self.enqueued_t = enqueued_t


class Permit:
    """One admitted request. Use as a context manager; call
    ``note_latency`` when the request's phase latency (TTFT) is known —
    that sample is what AIMD adapts the limit against."""

    __slots__ = ("_limiter", "priority", "admitted_t", "latency_s",
                 "_released")

    def __init__(self, limiter: "AdaptiveLimiter", priority: str,
                 admitted_t: float):
        self._limiter = limiter
        self.priority = priority
        self.admitted_t = admitted_t
        self.latency_s: float | None = None
        self._released = False

    def note_latency(self, seconds: float) -> None:
        if self.latency_s is None:
            self.latency_s = seconds

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._limiter._release(self)

    def __enter__(self) -> "Permit":
        return self

    def __exit__(self, *_exc) -> None:
        self.release()


class AdaptiveLimiter:
    """AIMD concurrency limiter + bounded priority wait queue +
    deadline-aware shedding + brownout pressure signal.

    ``admit()`` returns a ``Permit`` or raises:

    - ``RateLimitedError`` (HTTP 429, not retryable as-is): the deadline
      cannot be met by the queue projection, the wait outlived the
      deadline, or batch traffic hit the brownout shed level.
    - ``OverloadedError`` (HTTP 503, retryable): the bounded wait queue
      is full — pure capacity, try again after Retry-After.
    """

    def __init__(self, config: OverloadConfig | None = None, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or OverloadConfig()
        self._clock = clock
        self.limit = float(self.cfg.initial_concurrency)
        self.inflight = 0
        self._queues: dict[str, collections.deque[_Waiter]] = {
            p: collections.deque() for p in PRIORITIES}
        # EWMA of observed per-phase latency; the admission-queue
        # projection and Retry-After both derive from it. None until the
        # first sample — projections are conservative (never shed on an
        # uncalibrated clock).
        self.avg_service_s: float | None = None
        self._last_decrease_t = -1e18
        self._rng = random.Random(f"{self.cfg.seed}:overload")
        # Local mirrors of the metrics (always available to tests).
        self.admitted_total = collections.Counter()   # priority -> n
        self.shed_counts = collections.Counter()      # (reason, priority)
        # Journal state: shed-event throttle + last brownout level.
        self._shed_journal: dict[tuple[str, str], list] = {}
        self._journal_level = 0
        self._m_shed = self._m_admitted = None
        self._m_limit = self._m_queue = self._m_level = None
        if metrics is not None:
            m = metrics.namespace("overload")
            self._m_shed = m.counter(
                "shed_total", "Requests shed by the overload defense",
                ["reason", "priority"])
            self._m_admitted = m.counter(
                "admitted_total", "Requests admitted past the limiter",
                ["priority"])
            self._m_limit = m.gauge(
                "concurrency_limit", "Current AIMD concurrency limit")
            self._m_queue = m.gauge(
                "admission_queue_depth", "Requests waiting for admission")
            self._m_level = m.gauge(
                "brownout_level", "Current brownout pressure level")
            self._m_limit.set(self.limit)

    # -- pressure / projections -----------------------------------------------
    def waiting(self) -> int:
        return sum(1 for q in self._queues.values()
                   for w in q if not w.fut.done())

    def pressure(self) -> float:
        """< 1 while slots are free; 1 + queue fraction once saturated."""
        waiting = self.waiting()
        if waiting:
            return 1.0 + waiting / max(1, self.cfg.queue_depth)
        return self.inflight / max(1.0, self.limit)

    def pressure_level(self) -> int:
        p = self.pressure()
        cfg = self.cfg
        level = (0 if p < cfg.level1_pressure else
                 1 if p < cfg.level2_pressure else
                 2 if p < cfg.level3_pressure else 3)
        if self._m_level is not None:
            self._m_level.set(level)
        if level != self._journal_level:
            # Brownout edges are rare and load-bearing (they gate batch
            # shedding and token clamping): every change is journaled.
            journal.emit(EventKind.BROWNOUT_CHANGE,
                         **{"from": self._journal_level, "to": level,
                            "pressure": round(p, 3)})
            self._journal_level = level
        return level

    def projected_wait_s(self, position: int) -> float:
        """Time until a new arrival at queue ``position`` would get a
        slot, from the calibrated service time. 0 until calibrated —
        never shed on a projection the limiter can't back up."""
        if not self.avg_service_s:
            return 0.0
        return (position + 1) * self.avg_service_s / max(1.0, self.limit)

    def retry_after_s(self) -> float:
        """Retry-After for shed responses: the queue-drain projection
        (or the config default before calibration), jittered ±20% from
        the seeded stream so shed clients don't return in lockstep."""
        base = (self.projected_wait_s(self.waiting())
                or self.cfg.retry_after_default_s)
        base *= 1.0 + 0.2 * (2.0 * self._rng.random() - 1.0)
        return max(0.1, min(self.cfg.retry_after_max_s, base))

    def clamp_max_tokens(self, requested: int | None) -> int | None:
        """Brownout hook: the max_tokens to apply, or None to leave the
        request alone."""
        cfg = self.cfg
        if (not cfg.brownout_max_tokens
                or self.pressure_level() < cfg.brownout_clamp_level):
            return None
        if requested is not None and requested <= cfg.brownout_max_tokens:
            return None
        return cfg.brownout_max_tokens

    # -- admission ------------------------------------------------------------
    async def admit(self, priority: str = PRIORITY_INTERACTIVE,
                    deadline_ms: float | None = None) -> Permit:
        if priority not in self._queues:
            priority = PRIORITY_INTERACTIVE
        cfg = self.cfg
        if deadline_ms is None:
            deadline_ms = cfg.default_deadline_ms
        if (priority == PRIORITY_BATCH
                and self.pressure_level() >= cfg.batch_shed_level):
            raise self._shed(
                "priority", priority,
                RateLimitedError(
                    "batch traffic shed under brownout "
                    f"(pressure level {self.pressure_level()})",
                    retry_after_s=self.retry_after_s()))
        if self.inflight < int(self.limit):
            return self._grant(priority)
        waiting = self.waiting()
        if waiting >= cfg.queue_depth:
            raise self._shed(
                "queue_full", priority,
                OverloadedError(
                    f"admission queue full ({waiting} waiting, "
                    f"limit {int(self.limit)})",
                    retry_after_s=self.retry_after_s()))
        projected = self.projected_wait_s(waiting)
        if projected * 1000.0 > deadline_ms:
            raise self._shed(
                "deadline", priority,
                RateLimitedError(
                    f"deadline {deadline_ms:.0f} ms infeasible: projected "
                    f"admission wait {projected * 1000.0:.0f} ms "
                    f"({waiting} ahead at limit {int(self.limit)})",
                    retry_after_s=self.retry_after_s()))
        waiter = _Waiter(asyncio.get_running_loop().create_future(),
                         priority, self._clock())
        self._queues[priority].append(waiter)
        if self._m_queue is not None:
            self._m_queue.set(self.waiting())
        try:
            await asyncio.wait_for(waiter.fut, deadline_ms / 1000.0)
        except asyncio.TimeoutError:
            raise self._shed(
                "deadline_wait", priority,
                RateLimitedError(
                    f"deadline {deadline_ms:.0f} ms expired while waiting "
                    "for admission",
                    retry_after_s=self.retry_after_s())) from None
        except asyncio.CancelledError:
            # Caller vanished mid-wait (client disconnect): if the
            # wakeup already transferred a slot to us, hand it back —
            # otherwise the slot leaks and capacity shrinks forever.
            if waiter.fut.done() and not waiter.fut.cancelled():
                self.inflight -= 1
                self._wake_waiters()
            raise
        finally:
            try:
                self._queues[priority].remove(waiter)
            except ValueError:
                pass
            if self._m_queue is not None:
                self._m_queue.set(self.waiting())
        # Granted: _wake_waiters already took the inflight slot for us.
        return self._grant(priority, counted=True)

    def _grant(self, priority: str, counted: bool = False) -> Permit:
        if not counted:
            self.inflight += 1
        self.admitted_total[priority] += 1
        if self._m_admitted is not None:
            self._m_admitted.inc(priority=priority)
        return Permit(self, priority, self._clock())

    def _shed(self, reason: str, priority: str, exc: Exception) -> Exception:
        self.shed_counts[(reason, priority)] += 1
        if self._m_shed is not None:
            self._m_shed.inc(reason=reason, priority=priority)
        # Decision plane: one typed shed event per (reason, priority)
        # per throttle interval, carrying how many siblings it speaks
        # for. Cause: the brownout edge when one is active (priority
        # sheds ARE the brownout acting), else root.
        now = self._clock()
        state = self._shed_journal.setdefault((reason, priority), [-1e18, 0])
        if now - state[0] >= _SHED_JOURNAL_INTERVAL_S:
            suppressed, state[0], state[1] = state[1], now, 0
            cause = (journal.recent_ref(EventKind.BROWNOUT_CHANGE)
                     if reason == "priority" else None)
            journal.emit(EventKind.SHED, cause=cause, reason=reason,
                         priority=priority, limit=int(self.limit),
                         waiting=self.waiting(), suppressed=suppressed)
        else:
            state[1] += 1
        # The typed reason rides the exception so the accounting stream
        # (llm/recorder.py RequestLedger) records WHY, not just that a
        # 429/503 happened.
        exc.shed_reason = reason
        return exc

    # -- release / AIMD -------------------------------------------------------
    def _release(self, permit: Permit) -> None:
        self.inflight -= 1
        if permit.latency_s is not None:
            self._observe(permit.latency_s)
        self._wake_waiters()

    def _observe(self, latency_s: float) -> None:
        cfg = self.cfg
        self.avg_service_s = (
            latency_s if self.avg_service_s is None
            else 0.8 * self.avg_service_s + 0.2 * latency_s)
        if latency_s * 1000.0 > cfg.target_latency_ms:
            now = self._clock()
            if now - self._last_decrease_t >= cfg.decrease_cooldown_s:
                self._last_decrease_t = now
                self.limit = max(float(cfg.min_concurrency),
                                 self.limit * cfg.multiplicative_decrease)
        else:
            self.limit = min(float(cfg.max_concurrency),
                             self.limit + cfg.additive_increase
                             / max(1.0, self.limit))
        if self._m_limit is not None:
            self._m_limit.set(self.limit)

    def _wake_waiters(self) -> None:
        """Hand freed slots to waiters — interactive strictly first, so
        batch can never starve interactive under brownout."""
        while self.inflight < int(self.limit):
            waiter = None
            for priority in PRIORITIES:
                q = self._queues[priority]
                while q:
                    w = q[0]
                    if w.fut.done():   # timed out / cancelled: discard
                        q.popleft()
                        continue
                    waiter = w
                    break
                if waiter is not None:
                    break
            if waiter is None:
                return
            self._queues[waiter.priority].popleft()
            self.inflight += 1     # the slot transfers with the wakeup
            waiter.fut.set_result(None)


# -- per-worker circuit breakers ----------------------------------------------


class CircuitBreaker:
    """closed -> open -> half-open state machine for one worker.

    ``record_failure`` on consecutive typed failures (or latency
    outliers vs. the worker's own EWMA) opens the breaker;
    ``allows()`` turns false until ``breaker_cooldown_s`` elapses, then
    a single half-open probe is admitted (``on_dispatch`` marks it in
    flight). Probe success closes the breaker; probe failure re-opens
    it for another cooldown."""

    __slots__ = ("cfg", "_clock", "state", "streak", "opened_t",
                 "ewma_latency_s", "samples", "probe_inflight", "opens",
                 "probation")

    def __init__(self, cfg: OverloadConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self.state = CLOSED
        self.streak = 0          # consecutive failures + outliers
        self.opened_t = 0.0
        self.ewma_latency_s: float | None = None
        self.samples = 0
        self.probe_inflight = False
        self.opens = 0           # total open transitions (observability)
        # Canary-gated join (llm/canary.py): a held breaker admits NO
        # traffic — not even the post-cooldown half-open probe — until
        # a success (the canary's, via direct routing) releases it.
        self.probation = False

    def allows(self) -> bool:
        if self.probation:
            return False
        if not self.cfg.breaker_enabled or self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() - self.opened_t < self.cfg.breaker_cooldown_s:
                return False
            self.state = HALF_OPEN
            self.probe_inflight = False
        return not self.probe_inflight

    def on_dispatch(self) -> None:
        if self.state == HALF_OPEN:
            self.probe_inflight = True

    def record_success(self, latency_s: float | None = None) -> None:
        self.probation = False
        if self.state in (HALF_OPEN, OPEN):
            # Probe (or a straggler from before the open) succeeded:
            # close and forget the episode.
            self.state = CLOSED
            self.probe_inflight = False
            self.streak = 0
            return
        outlier = (latency_s is not None
                   and self.ewma_latency_s is not None
                   and self.samples >= self.cfg.breaker_min_samples
                   and latency_s > self.cfg.breaker_latency_factor
                   * self.ewma_latency_s)
        if latency_s is not None:
            self.ewma_latency_s = (
                latency_s if self.ewma_latency_s is None
                else 0.9 * self.ewma_latency_s + 0.1 * latency_s)
            self.samples += 1
        if outlier:
            self.streak += 1
            self._maybe_open()
        else:
            self.streak = 0

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self._open()
            return
        self.streak += 1
        self._maybe_open()

    def _maybe_open(self) -> None:
        if self.state == CLOSED and self.streak >= self.cfg.breaker_failures:
            self._open()

    def _open(self) -> None:
        self.state = OPEN
        self.opened_t = self._clock()
        self.probe_inflight = False
        self.opens += 1


class BreakerBoard:
    """Per-worker breakers for one client/endpoint. The request-plane
    client records outcomes; the scheduler/router asks ``admitted()``
    to exclude open instances."""

    def __init__(self, config: OverloadConfig | None = None, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or OverloadConfig()
        self._clock = clock
        self._breakers: dict[int, CircuitBreaker] = {}
        self._m_state = self._m_opens = None
        if metrics is not None:
            m = metrics.namespace("overload")
            self._m_state = m.gauge(
                "breaker_open", "1 while a worker's circuit is open",
                ["worker"])
            self._m_opens = m.counter(
                "breaker_opens_total", "Circuit-open transitions",
                ["worker"])

    def breaker(self, worker_id: int) -> CircuitBreaker:
        b = self._breakers.get(worker_id)
        if b is None:
            b = self._breakers[worker_id] = CircuitBreaker(
                self.cfg, self._clock)
        return b

    def state(self, worker_id: int) -> str:
        b = self._breakers.get(worker_id)
        return b.state if b else CLOSED

    def admitted(self, worker_ids: Iterable[int]) -> list[int]:
        """The subset a scheduler may route to right now (half-open
        probes included, one at a time per worker)."""
        return [w for w in worker_ids if self.breaker(w).allows()]

    def on_dispatch(self, worker_id: int) -> None:
        self.breaker(worker_id).on_dispatch()

    def record_success(self, worker_id: int,
                       latency_s: float | None = None,
                       cause: str | None = None) -> None:
        """``cause``: the journal ref of whatever proved the worker
        healthy (a canary_ok probe passes its own event) — plain
        request-plane successes leave it None."""
        b = self.breaker(worker_id)
        before = b.state
        b.record_success(latency_s)
        if before != CLOSED and b.state == CLOSED:
            log.info("worker %x circuit closed (probe succeeded)", worker_id)
            journal.emit(EventKind.BREAKER_TRANSITION, cause=cause,
                         worker_id=f"{worker_id:x}",
                         **{"from": before, "to": CLOSED})
            self._publish(worker_id)

    def record_failure(self, worker_id: int,
                       cause: str | None = None) -> None:
        """``cause``: the journal ref of the failure's origin when the
        caller knows it (a canary_fail probe passes its own event);
        with chaos armed, an open without an explicit cause names the
        most recent injection — the decision that opened the breaker is
        attributable either way."""
        b = self.breaker(worker_id)
        before = b.state
        b.record_failure()
        if b.state == OPEN and before != OPEN:
            log.warning("worker %x circuit OPEN after %d consecutive "
                        "failures; excluded for %.1fs", worker_id,
                        b.streak, self.cfg.breaker_cooldown_s)
            if cause is None:
                cause = journal.recent_ref(EventKind.CHAOS_INJECT)
            journal.emit(EventKind.BREAKER_TRANSITION, cause=cause,
                         worker_id=f"{worker_id:x}", streak=b.streak,
                         cooldown_s=self.cfg.breaker_cooldown_s,
                         **{"from": before, "to": OPEN})
            if self._m_opens is not None:
                self._m_opens.inc(worker=f"{worker_id:x}")
            self._publish(worker_id)

    def hold(self, worker_id: int, cause: str | None = None) -> None:
        """Canary-gated join: hold this worker's breaker — NO user
        traffic, not even half-open probes — until something records a
        success (the canary's direct-routed probe, which bypasses
        breaker filtering). ``cause`` is the journal ref that put it on
        probation (the worker_join event)."""
        b = self.breaker(worker_id)
        if b.probation:
            return
        before = b.state
        b.probation = True
        b.state = OPEN
        b.opened_t = self._clock()
        journal.emit(EventKind.BREAKER_TRANSITION, cause=cause,
                     worker_id=f"{worker_id:x}", reason="probation",
                     **{"from": before, "to": OPEN})
        self._publish(worker_id)

    def remove(self, worker_id: int) -> None:
        self._breakers.pop(worker_id, None)

    def _publish(self, worker_id: int) -> None:
        if self._m_state is not None:
            b = self._breakers[worker_id]
            self._m_state.set(1.0 if b.state == OPEN else 0.0,
                              worker=f"{worker_id:x}")
