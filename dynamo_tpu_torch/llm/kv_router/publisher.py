"""Worker-side publishers (copy of
``dynamo_tpu.llm.kv_router.publisher``): KV cache events, forward-pass
load metrics and inventory digests, on the component's subjects of the
coordinator's pub/sub plane. The engine schedules them on the worker's
event loop after processed windows.
"""

from __future__ import annotations

import asyncio
import itertools
import time

from dynamo_tpu_torch.llm.kv_router.protocols import (ForwardPassMetrics,
                                                      KvCacheEvent,
                                                      KvInventoryDigest,
                                                      RouterEvent,
                                                      kv_events_subject,
                                                      kv_inventory_subject,
                                                      load_metrics_subject)
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("kv_publisher")


class KvEventPublisher:
    def __init__(self, runtime, namespace: str, component: str,
                 worker_id: int):
        self._client = runtime.require_coordinator()
        self.subject = kv_events_subject(namespace, component)
        self.worker_id = worker_id
        self._ids = itertools.count(1)

    async def publish(self, event: KvCacheEvent) -> None:
        event.event_id = next(self._ids)
        router_event = RouterEvent(worker_id=self.worker_id, event=event)
        await self._client.publish(self.subject, router_event.to_wire())

    async def stored(self, block_hashes: list[int],
                     parent_hash: int | None = None) -> None:
        await self.publish(KvCacheEvent.stored(block_hashes, parent_hash))

    async def removed(self, block_hashes: list[int]) -> None:
        await self.publish(KvCacheEvent.removed(block_hashes))

    async def cleared(self) -> None:
        await self.publish(KvCacheEvent.cleared())


class WorkerMetricsPublisher:
    """Publishes ForwardPassMetrics, at most one message per
    ``min_interval_s`` unless forced (windows can be sub-ms)."""

    def __init__(self, runtime, namespace: str, component: str,
                 worker_id: int, min_interval_s: float = 0.1):
        self._client = runtime.require_coordinator()
        self.subject = load_metrics_subject(namespace, component)
        self.worker_id = worker_id
        self.min_interval_s = min_interval_s
        self._last = 0.0
        self.latest: ForwardPassMetrics | None = None

    async def publish(self, metrics: ForwardPassMetrics,
                      force: bool = False) -> None:
        metrics.worker_id = self.worker_id
        self.latest = metrics
        now = asyncio.get_running_loop().time()
        if not force and now - self._last < self.min_interval_s:
            return
        self._last = now
        await self._client.publish(self.subject, metrics.to_wire())


class KvInventoryPublisher:
    """Publishes KvInventoryDigest snapshots; a digest is a summary, so
    the default cadence is coarser than the load metrics'."""

    def __init__(self, runtime, namespace: str, component: str,
                 worker_id: int, min_interval_s: float = 2.0):
        self._client = runtime.require_coordinator()
        self.subject = kv_inventory_subject(namespace, component)
        self.worker_id = worker_id
        self.min_interval_s = min_interval_s
        self._last = 0.0
        self._seq = 0
        self.published = 0
        self._periodic: asyncio.Task | None = None

    def due(self, now: float) -> bool:
        """Cheap engine-loop gate: is the next digest worth building?"""
        return now - self._last >= self.min_interval_s

    async def publish(self, digest: KvInventoryDigest,
                      force: bool = False) -> None:
        now = asyncio.get_running_loop().time()
        if not force and now - self._last < self.min_interval_s:
            return
        self._last = now
        self._seq += 1
        digest.worker_id = self.worker_id
        digest.seq = self._seq
        digest.ts = time.time()
        await self._client.publish(self.subject, digest.to_wire())
        self.published += 1

    def start_periodic(self, digest_fn) -> None:
        """Republish in the background so an idle worker still advertises
        its inventory (the engine publishes only while it processes
        windows); publish()'s throttle dedups against the engine's."""

        async def loop() -> None:
            while True:
                await asyncio.sleep(self.min_interval_s)
                try:
                    await self.publish(digest_fn())
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — telemetry, keep going
                    # Includes "dict changed size" races against the
                    # engine thread: the next tick retries.
                    log.exception("periodic inventory publish failed")

        if self._periodic is None:
            self._periodic = asyncio.create_task(loop())

    def stop_periodic(self) -> None:
        if self._periodic is not None:
            self._periodic.cancel()
            self._periodic = None
