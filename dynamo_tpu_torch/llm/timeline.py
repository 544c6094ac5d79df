"""Frontend timeline collector: the fleet's merged decision plane (copy
of ``dynamo_tpu.llm.timeline``).

Workers publish journal deltas on the namespace's journal subject
(``runtime/journal.py JournalPublisher``); this collector subscribes,
feeds ``FleetTimeline`` (seq-fenced merge with restart and overflow
``journal_gap`` marking, stale-stream pruning) and serves the result,
merged with the frontend's own journal, as the ``GET /debug/timeline``
payload. It merges JAX and port workers alike: the subject, payload and
event kinds are the reference's.
"""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.runtime import journal as journal_mod
from dynamo_tpu_torch.runtime.journal import (FleetTimeline, journal_subject,
                                        merge_timeline)
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("timeline")

#: Stream fences for workers that stop publishing are pruned after this
#: long (the lease TTL bounds real death detection; this only bounds
#: fence memory — merged history is kept).
DEFAULT_TTL_S = 60.0


class TimelineCollector:
    def __init__(self, runtime, namespace: str | None = None,
                 ttl_s: float = DEFAULT_TTL_S):
        self._runtime = runtime
        self.namespace = namespace or runtime.config.namespace
        self.fleet = FleetTimeline(ttl_s=ttl_s)
        self._sub = None
        self._task: asyncio.Task | None = None
        self._prune_task: asyncio.Task | None = None

    async def start(self) -> None:
        client = self._runtime.require_coordinator()
        self._sub = await client.subscribe(journal_subject(self.namespace))
        self._task = asyncio.create_task(self._loop())
        self._prune_task = asyncio.create_task(self._prune_loop())

    async def stop(self) -> None:
        for task in (self._task, self._prune_task):
            if task is not None:
                task.cancel()
        self._task = self._prune_task = None
        if self._sub is not None:
            await self._sub.cancel()
            self._sub = None

    async def _loop(self) -> None:
        async for msg in self._sub:
            try:
                self.fleet.apply_delta(msg["payload"])
            except Exception:  # noqa: BLE001 — one bad delta, keep merging
                log.exception("bad journal delta")

    async def _prune_loop(self) -> None:
        while True:
            await asyncio.sleep(self.fleet.ttl_s / 2)
            try:
                dead = self.fleet.prune()
                if dead:
                    log.info("pruned journal stream fences: %s",
                             ", ".join(dead))
            except Exception:  # noqa: BLE001 — maintenance only
                log.exception("timeline prune failed")

    # -- /debug/timeline provider ---------------------------------------------
    def timeline_status(self, limit: int = 512) -> dict:
        """The merged fleet timeline + this process's own journal, one
        causally ordered stream."""
        local = journal_mod.get_journal()
        snap = self.fleet.snapshot(limit=0)
        events = merge_timeline(snap.pop("events"), local, limit=limit)
        return {
            "role": "frontend",
            "local": {"worker": local.worker, "boot": local.boot,
                      "seq": local.seq,
                      "emitted_total": local.emitted_total,
                      "dropped_overflow": local.dropped_overflow},
            **snap,
            "events": events,
        }
