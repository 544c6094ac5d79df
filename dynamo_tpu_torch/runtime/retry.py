"""Retry policy: jittered exponential backoff and retry budgets (copy of
``dynamo_tpu.runtime.retry``'s ``RetryPolicy``, ``RetryBudget``,
``Backoff`` and the policies the coordinator client, ``Migration``, the
KV plane and the prefill queue use).

A ``RetryPolicy`` describes the curve, a ``Backoff`` walks it for one
operation, and a shared ``RetryBudget`` (token bucket) keeps a fleet of
callers from synchronizing into a retry storm: once the budget drains,
retries still happen, but at the policy's max delay.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import time


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """An exponential-backoff curve with full-range jitter."""

    initial_delay_s: float = 0.25
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.1  # +/- fraction applied to each delay
    max_attempts: int | None = None  # None = retry forever

    def delay(self, attempt: int) -> float:
        base = min(self.max_delay_s,
                   self.initial_delay_s * self.multiplier ** attempt)
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(0.0, base)


class RetryBudget:
    """Token bucket bounding how fast a caller may retry. Each retry
    spends one token; tokens refill at ``rate`` per second up to
    ``burst``. An empty budget does not forbid the retry: it forces it to
    the policy's max delay."""

    def __init__(self, rate: float = 2.0, burst: float = 10.0):
        self.rate = rate
        self.burst = burst
        self._tokens = burst
        self._t = time.monotonic()

    def try_spend(self, cost: float = 1.0) -> bool:
        now = time.monotonic()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= cost:
            self._tokens -= cost
            return True
        return False


class Backoff:
    """Stateful per-operation walk of a RetryPolicy."""

    def __init__(self, policy: RetryPolicy,
                 budget: RetryBudget | None = None):
        self.policy = policy
        self.budget = budget
        self.attempt = 0

    def next_delay(self) -> float | None:
        """The next sleep, or None when attempts are exhausted. An empty
        retry budget escalates the delay to the policy max instead of
        giving up (budget = pacing, max_attempts = termination)."""
        p = self.policy
        if p.max_attempts is not None and self.attempt >= p.max_attempts:
            return None
        d = p.delay(self.attempt)
        self.attempt += 1
        if self.budget is not None and not self.budget.try_spend():
            d = max(d, p.max_delay_s)
        return d

    async def sleep(self) -> bool:
        """Back off once. False when attempts are exhausted."""
        d = self.next_delay()
        if d is None:
            return False
        await asyncio.sleep(d)
        return True

    def sleep_sync(self) -> bool:
        """Back off once on a plain thread (KV-plane pulls)."""
        d = self.next_delay()
        if d is None:
            return False
        time.sleep(d)
        return True

    def reset(self) -> None:
        """Re-arm the curve after a success."""
        self.attempt = 0


class policies:
    """The named retry policies: the one place delay constants live."""

    # First dial to a coordinator that may still be starting up.
    COORD_CONNECT = RetryPolicy(initial_delay_s=0.25, max_delay_s=2.0,
                                multiplier=1.5, jitter=0.1, max_attempts=40)
    # Redial after a coordinator crash/restart: forever, capped.
    COORD_RECONNECT = RetryPolicy(initial_delay_s=0.25, max_delay_s=5.0,
                                  multiplier=1.5, jitter=0.2)
    # Prefill-queue pops after a failure: forever, capped.
    QUEUE_POP = RetryPolicy(initial_delay_s=0.25, max_delay_s=5.0,
                            multiplier=2.0, jitter=0.2)
    # KV-plane parcel pulls: bounded; past a few attempts the decode
    # worker prefills locally.
    KV_PULL = RetryPolicy(initial_delay_s=0.05, max_delay_s=1.0,
                          multiplier=2.0, jitter=0.2, max_attempts=3)
    # Request-plane migration retries: near-immediate (the stream is
    # user-visible latency) but jittered so a worker death does not make
    # every migrated stream redial in lockstep.
    MIGRATION = RetryPolicy(initial_delay_s=0.05, max_delay_s=1.0,
                            multiplier=2.0, jitter=0.5)
