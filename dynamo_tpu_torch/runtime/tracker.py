"""Structured background-task tracking.

Capability parity with reference tracker.rs (lib/runtime/src/utils/tasks/
tracker.rs: TaskTracker + OnErrorPolicy / SchedulingPolicy / critical
handles): spawn supervised asyncio tasks with per-task error policies —
log-and-stop, retry with exponential backoff, or critical (failure
triggers runtime shutdown) — a concurrency-limiting scheduler, cancel-all
shutdown, and success/failure/retry counters.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import time
from typing import Any, Awaitable, Callable

from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("tracker")


class OnError(enum.Enum):
    """Error policy (tracker.rs OnErrorPolicy)."""
    LOG = "log"           # record the failure, task ends
    RETRY = "retry"       # re-run with exponential backoff up to a limit
    CRITICAL = "critical"  # failure calls the tracker's on_critical hook


@dataclasses.dataclass
class TaskRecord:
    name: str
    policy: OnError
    started_at: float
    attempts: int = 0
    done: bool = False
    failed: bool = False
    cancelled: bool = False
    error: str | None = None
    result: Any = None


class TrackedHandle:
    """Await-able handle to a tracked task (tracker.rs TaskHandle)."""

    def __init__(self, record: TaskRecord, task: asyncio.Task):
        self.record = record
        self._task = task

    def __await__(self):
        return self._task.__await__()

    def cancel(self) -> None:
        self._task.cancel()

    @property
    def done(self) -> bool:
        return self._task.done()


class TaskTracker:
    def __init__(self, max_concurrency: int | None = None,
                 on_critical: Callable[[str, BaseException], None]
                 | None = None):
        self._sem = (asyncio.Semaphore(max_concurrency)
                     if max_concurrency else None)
        self._on_critical = on_critical
        self._tasks: set[asyncio.Task] = set()
        self.records: list[TaskRecord] = []
        self.succeeded = 0
        self.failed = 0
        self.retried = 0
        self._closed = False

    def spawn(self, name: str, fn: Callable[[], Awaitable],
              policy: OnError = OnError.LOG, max_retries: int = 3,
              backoff_s: float = 0.05) -> TrackedHandle:
        """Supervise ``fn`` (a zero-arg coroutine factory — retries need to
        re-create the coroutine)."""
        if self._closed:
            raise RuntimeError("tracker is shut down")
        record = TaskRecord(name=name, policy=policy,
                            started_at=time.monotonic())
        self.records.append(record)
        task = asyncio.create_task(
            self._run(record, fn, max_retries, backoff_s), name=name)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return TrackedHandle(record, task)

    async def _run(self, record: TaskRecord, fn, max_retries: int,
                   backoff_s: float):
        while True:
            record.attempts += 1
            try:
                if self._sem is not None:
                    async with self._sem:
                        result = await fn()
                else:
                    result = await fn()
            except asyncio.CancelledError:
                record.cancelled = True
                record.done = True
                raise
            except Exception as exc:  # noqa: BLE001 — supervision point
                record.error = f"{type(exc).__name__}: {exc}"
                if (record.policy is OnError.RETRY
                        and record.attempts <= max_retries):
                    self.retried += 1
                    delay = backoff_s * (2 ** (record.attempts - 1))
                    log.warning("task %s failed (%s); retry %d/%d in %.2fs",
                                record.name, record.error, record.attempts,
                                max_retries, delay)
                    await asyncio.sleep(delay)
                    continue
                record.failed = True
                record.done = True
                self.failed += 1
                if record.policy is OnError.CRITICAL:
                    log.error("CRITICAL task %s failed: %s", record.name,
                              record.error)
                    if self._on_critical is not None:
                        self._on_critical(record.name, exc)
                else:
                    log.warning("task %s failed: %s", record.name,
                                record.error)
                raise
            else:
                record.done = True
                record.result = result
                self.succeeded += 1
                return result

    @property
    def active_count(self) -> int:
        return len(self._tasks)

    async def shutdown(self, timeout_s: float = 5.0) -> None:
        """Cancel everything still running and wait (tracker.rs
        cancel-all)."""
        self._closed = True
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.wait(list(self._tasks), timeout=timeout_s)
