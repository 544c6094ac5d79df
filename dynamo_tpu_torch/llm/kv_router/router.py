"""The KV-aware router engine (copy of
``dynamo_tpu.llm.kv_router.router``).

``KvPushRouter`` subscribes to the component's kv_events, load_metrics,
router_sync and kv_inventory subjects, keeps the radix index, per-worker
load and the fleet inventory, and sends each preprocessed request
straight to the worker with the best overlap/load cost
(``EndpointClient.generate(..., instance_id=...)``). Router replicas stay
consistent by publishing their add/mark/free decisions on router_sync
and by dropping workers that discovery no longer lists.

The reference's Prometheus gauges, counters and histogram and its
``router.decide`` span wait for ROADMAP item 12 (the port has no
``runtime/metrics.py`` or tracing yet); the decision and federation counts
are plain integers in ``kv_status()``.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import AsyncIterator

from dynamo_tpu_torch.llm.kv_router.fleet import DecisionLog, FleetInventory
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.llm.kv_router.protocols import (ForwardPassMetrics,
                                                      KvInventoryDigest,
                                                      RouterEvent,
                                                      kv_events_subject,
                                                      kv_inventory_subject,
                                                      load_metrics_subject,
                                                      router_sync_subject)
from dynamo_tpu_torch.llm.kv_router.scheduler import (KvRouterConfig,
                                                      KvScheduler)
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequencesMultiWorker
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.llm.tokens import chain_salt, compute_block_hashes
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("kv_router")

#: Prune-loop ticks (one second each) a worker must be absent from
#: discovery before its routing state is dropped.
ABSENT_TICKS = 3


class KvPushRouter(AsyncEngine):
    def __init__(self, runtime, namespace: str, component: str, client,
                 config: KvRouterConfig):
        self._runtime = runtime
        self.namespace = namespace
        self.component = component
        self.client = client  # EndpointClient
        self.config = config
        self.indexer = KvIndexer(config.block_size)
        self.sequences = ActiveSequencesMultiWorker()
        self.scheduler = KvScheduler(config, self.sequences)
        self.replica_id = uuid.uuid4().hex[:8]
        self._tasks: list[asyncio.Task] = []
        self._bg_tasks: set[asyncio.Task] = set()
        self._subs = []
        self.fleet = FleetInventory()
        self.decisions = DecisionLog()
        # Decisions by cache awareness, and by the source of the chosen
        # worker's overlap ("radix", "inventory" or "none").
        self.outcomes = {"best": 0, "suboptimal": 0}
        self.federation_sources = {"radix": 0, "inventory": 0, "none": 0}

    async def start(self) -> None:
        coord = self._runtime.require_coordinator()
        subs = []
        for subject in (kv_events_subject, load_metrics_subject,
                        router_sync_subject, kv_inventory_subject):
            subs.append(await coord.subscribe(
                subject(self.namespace, self.component)))
        self._subs = subs
        ev_sub, load_sub, sync_sub, inv_sub = subs
        self._tasks = [
            asyncio.create_task(self._event_loop(ev_sub)),
            asyncio.create_task(self._load_loop(load_sub)),
            asyncio.create_task(self._sync_loop(sync_sub)),
            asyncio.create_task(self._inventory_loop(inv_sub)),
            asyncio.create_task(self._prune_loop()),
        ]

    async def close(self) -> None:
        for task in self._tasks:
            task.cancel()
        for sub in self._subs:
            await sub.cancel()
        await self.client.close()

    # -- background state maintenance ----------------------------------------
    async def _event_loop(self, sub) -> None:
        async for msg in sub:
            try:
                self.indexer.apply(RouterEvent.from_wire(msg["payload"]))
            except Exception:  # noqa: BLE001
                log.exception("bad kv event")

    async def _load_loop(self, sub) -> None:
        async for msg in sub:
            try:
                self.scheduler.update_metrics(
                    ForwardPassMetrics.from_wire(msg["payload"]))
            except Exception:  # noqa: BLE001
                log.exception("bad load metrics")

    async def _inventory_loop(self, sub) -> None:
        async for msg in sub:
            try:
                self.fleet.apply(KvInventoryDigest.from_wire(msg["payload"]))
            except Exception:  # noqa: BLE001
                log.exception("bad kv inventory digest")

    async def _sync_loop(self, sub) -> None:
        """Apply other replicas' optimistic add/mark/free events."""
        async for msg in sub:
            payload = msg["payload"]
            if payload.get("replica") == self.replica_id:
                continue
            kind = payload.get("kind")
            if kind == "add":
                self.sequences.add_request(
                    payload["worker_id"], payload["request_id"],
                    payload["blocks"], payload["prefill_tokens"])
            elif kind == "mark":
                self.sequences.mark_prefill_complete(
                    payload["worker_id"], payload["request_id"])
            elif kind == "free":
                self.sequences.free(payload["worker_id"],
                                    payload["request_id"])

    async def _prune_loop(self) -> None:
        """Drop the state of workers that discovery no longer lists, after
        ABSENT_TICKS consecutive absent ticks: KV events are incremental,
        so wiping on a transient blip would lose a live worker's index."""
        absent: dict[int, int] = {}
        while True:
            await asyncio.sleep(1.0)
            live = set(self.client.instance_ids())
            gone = (self.indexer.tree.workers() | self.fleet.workers()) - live
            for worker in gone:
                absent[worker] = absent.get(worker, 0) + 1
                if absent[worker] >= ABSENT_TICKS:
                    log.info("worker %x gone; dropping its indexed blocks",
                             worker)
                    self._drop_worker(worker)
                    absent.pop(worker, None)
            for worker in list(absent):
                if worker in live:
                    absent.pop(worker)

    def _drop_worker(self, worker_id: int) -> None:
        self.indexer.tree.remove_worker(worker_id)
        self.scheduler.remove_worker(worker_id)
        self.fleet.remove_worker(worker_id)

    def note_worker_leave(self, worker_id: int) -> None:
        """Discovery's worker-leave hook (scale-in, crash): drop the
        worker's routing state at once instead of waiting out the prune
        loop and the digest staleness, so a retired worker's inventory
        stops attracting requests."""
        self._drop_worker(worker_id)
        log.info("worker %x left; routing state dropped immediately",
                 worker_id)

    def kv_status(self) -> dict:
        """Index size, fleet inventory, decision telemetry and the
        decision counts."""
        return {
            "role": "kv_router",
            "component": self.component,
            "federation": self.config.federation,
            "index": {"blocks": self.indexer.tree.num_blocks,
                      "workers": sorted(f"{w:x}" for w in
                                        self.indexer.tree.workers())},
            "fleet": self.fleet.snapshot(),
            "decisions": self.decisions.snapshot(),
            "outcomes": dict(self.outcomes),
            "federation_sources": dict(self.federation_sources),
            "load": {f"{w:x}": m.to_wire()
                     for w, m in sorted(self.scheduler.metrics.items())},
        }

    async def _publish_sync(self, payload: dict) -> None:
        payload["replica"] = self.replica_id
        try:
            await self._runtime.require_coordinator().publish(
                router_sync_subject(self.namespace, self.component), payload)
        except (ConnectionError, RuntimeError):
            pass

    def _decide(self, req: PreprocessedRequest) -> tuple[int, int, int]:
        """(worker, its overlap, request blocks) for one request."""
        # An adapter request hashes under the adapter's chain salt, the
        # chain its worker registers the adapter's KV under.
        block_hashes = compute_block_hashes(
            req.token_ids, self.config.block_size,
            salt=chain_salt(req.adapter))
        request_blocks = max(1, len(block_hashes))
        radix = self.indexer.tree.find_matches(block_hashes)
        workers = self.client.instance_ids()
        # Federated scoring: per worker, the larger of the radix view and
        # the inventory-sketch view (which never overclaims).
        union = dict(radix)
        for w, est in self.fleet.prefix_overlaps(workers,
                                                 block_hashes).items():
            if est > union.get(w, 0):
                union[w] = est
        scoring = union if self.config.federation else radix
        worker_id, _ = self.scheduler.select(workers, request_blocks, scoring)
        # The chosen worker's real overlap is the union view even when
        # scoring was radix-only.
        overlap = union.get(worker_id, 0)
        source = ("none" if overlap <= 0
                  else "radix" if radix.get(worker_id, 0) >= overlap
                  else "inventory")
        self.federation_sources[source] += 1
        # "Best" is over the fleet view, so busy exclusions and
        # federation-off routing show as regret.
        best_overlap = max(union.values(), default=0)
        self.decisions.note(worker_id, overlap, best_overlap, request_blocks)
        self.outcomes["best" if overlap >= best_overlap else "suboptimal"] += 1
        return worker_id, overlap, request_blocks

    # -- engine interface -----------------------------------------------------
    async def generate(self, request, context: Context) -> AsyncIterator[dict]:
        req = (request if isinstance(request, PreprocessedRequest)
               else PreprocessedRequest.from_wire(request))
        worker_id, overlap, request_blocks = self._decide(req)
        new_blocks = request_blocks - overlap
        request_id = context.id
        prefill_tokens = max(0, len(req.token_ids)
                             - overlap * self.config.block_size)
        self.sequences.add_request(worker_id, request_id, new_blocks,
                                   prefill_tokens)
        await self._publish_sync({
            "kind": "add", "worker_id": worker_id, "request_id": request_id,
            "blocks": new_blocks, "prefill_tokens": prefill_tokens})
        req.estimated_prefix_hit_blocks = overlap
        prefill_done = False
        try:
            stream = await self.client.generate(
                req.to_wire(), context=context, instance_id=worker_id)
            async for item in stream:
                if not prefill_done and isinstance(item, dict) \
                        and item.get("token_ids"):
                    # First token: the worker finished this request's
                    # prefill, so its outstanding prefill load goes.
                    prefill_done = True
                    self.sequences.mark_prefill_complete(worker_id,
                                                         request_id)
                    # Fire and forget: replica sync must not add a
                    # coordinator round trip to the TTFT. Hold a
                    # reference (the loop keeps tasks only weakly).
                    t = asyncio.ensure_future(self._publish_sync({
                        "kind": "mark", "worker_id": worker_id,
                        "request_id": request_id}))
                    self._bg_tasks.add(t)
                    t.add_done_callback(self._bg_tasks.discard)
                yield item
        finally:
            self.sequences.free(worker_id, request_id)
            await self._publish_sync({
                "kind": "free", "worker_id": worker_id,
                "request_id": request_id})


def make_kv_router_factory(overlap_score_weight: float = 1.0,
                           temperature: float = 0.0,
                           busy_threshold: float | None = None,
                           federation: bool = True):
    """The factory ModelWatcher calls under --router-mode kv."""

    async def factory(runtime, entry, client) -> KvPushRouter:
        config = KvRouterConfig(
            overlap_score_weight=overlap_score_weight,
            temperature=temperature,
            busy_threshold=busy_threshold,
            federation=federation,
            block_size=entry.card.kv_cache_block_size)
        router = KvPushRouter(runtime, entry.namespace, entry.component,
                              client, config)
        await router.start()
        return router

    return factory
