"""Mocker: an engine simulator with real KV events and load metrics (copy
of ``dynamo_tpu.llm.mocker``).

A continuous-batching simulation (waiting, prefill and decode with token
budgets), a paged KV cache with prefix reuse and LRU eviction that emits
real stored/removed KV events, and ForwardPassMetrics publishing, so KV
routing, overload, migration, role flips and the planner are testable
without a card. Prefill runs at a fixed tok/s and each decode iteration
takes a fixed step time; generation echoes the prompt's tokens.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import OrderedDict
from typing import AsyncIterator

from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics, KvStats, WorkerStats
from dynamo_tpu_torch.llm.protocols import FinishReason, LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.tracing import get_recorder

log = get_logger("mocker")


@dataclasses.dataclass
class MockerConfig:
    num_kv_blocks: int = 1024
    block_size: int = 16
    max_num_seqs: int = 64
    max_batched_tokens: int = 8192
    prefill_tokens_per_s: float = 100_000.0
    decode_step_s: float = 0.005
    speedup_ratio: float = 1.0  # reference mocker/protocols.rs:79
    # Simulated host (G2) tier: evicted blocks land here instead of
    # vanishing, stay out of the radix index (their removed events
    # fire) but in the inventory digest, for routing and peer-pull tests
    # without a card. 0 disables it.
    host_blocks: int = 0

    def prefill_time(self, tokens: int) -> float:
        return tokens / self.prefill_tokens_per_s / self.speedup_ratio

    def decode_time(self) -> float:
        return self.decode_step_s / self.speedup_ratio


class KvCacheSim:
    """Paged KV cache simulation with prefix reuse + LRU eviction
    (reference mocker/kv_manager.rs). Emits stored/removed hashes via the
    events lists drained by the engine loop."""

    def __init__(self, capacity: int, host_capacity: int = 0):
        self.capacity = capacity
        # block_hash -> refcount; insertion order refreshed on use = LRU.
        self._blocks: OrderedDict[int, int] = OrderedDict()
        # Simulated G2 host tier: eviction victims demote here (LRU,
        # bounded); an admit that misses G1 but hits here ONBOARDS the
        # block back (promote-on-hit) instead of "recomputing".
        self.host_capacity = host_capacity
        self.host: OrderedDict[int, bool] = OrderedDict()
        self.host_onboards = 0
        self.host_spills = 0
        self.peer_onboards = 0
        self.stored_events: list[int] = []
        self.removed_events: list[int] = []

    def lookup_prefix(self, hashes: list[int]) -> int:
        """Longest cached prefix (cache hit blocks) for a new sequence,
        across G1 and the host-tier sim (a host block onboards during
        allocate() instead of 'recomputing' — it counts as a hit).
        Refreshes recency of the G1 hits."""
        n = 0
        for h in hashes:
            if h in self._blocks:
                self._blocks.move_to_end(h)
                n += 1
            elif h in self.host:
                n += 1
            else:
                break
        return n

    def allocate(self, hashes: list[int]) -> bool:
        """Pin all blocks of ``hashes`` (allocating misses). False if the pool
        can't fit even after evicting unpinned blocks."""
        wanted = set(hashes)
        misses = [h for h in hashes if h not in self._blocks]
        free_needed = len(self._blocks) + len(misses) - self.capacity
        if free_needed > 0 and not self._evict(free_needed, protect=wanted):
            return False
        for h in hashes:
            if h in self._blocks:
                self._blocks[h] += 1
                self._blocks.move_to_end(h)
            else:
                if self.host.pop(h, None) is not None:
                    # Promote-on-hit from the simulated host tier.
                    self.host_onboards += 1
                self._blocks[h] = 1
                self.stored_events.append(h)
        return True

    def _evict(self, count: int, protect: set[int] = frozenset()) -> bool:
        """Evict ``count`` unpinned LRU blocks, never touching ``protect``
        (the request being allocated — evicting its own reusable blocks would
        overflow capacity and emit bogus removed+stored event pairs)."""
        victims = [h for h, ref in self._blocks.items()
                   if ref == 0 and h not in protect]
        if len(victims) < count:
            return False
        for h in victims[:count]:
            del self._blocks[h]
            self.removed_events.append(h)
            if self.host_capacity > 0:
                # Demote to the host-tier sim instead of dropping.
                self.host[h] = True
                self.host.move_to_end(h)
                self.host_spills += 1
                while len(self.host) > self.host_capacity:
                    self.host.popitem(last=False)
        return True

    def inject(self, h: int) -> None:
        """A peer-pulled block lands as a reusable (unpinned) local
        block — allocate() then counts it as a hit instead of a miss."""
        if h not in self._blocks:
            self._blocks[h] = 0
            self.stored_events.append(h)
            self.peer_onboards += 1

    def append_block(self, h: int) -> bool:
        """Allocate one new pinned block for a decoding sequence."""
        return self.allocate([h]) if h not in self._blocks else self._pin(h)

    def _pin(self, h: int) -> bool:
        self._blocks[h] += 1
        self._blocks.move_to_end(h)
        return True

    def release(self, hashes: list[int]) -> None:
        """Unpin (blocks stay cached for prefix reuse until evicted)."""
        for h in hashes:
            if h in self._blocks and self._blocks[h] > 0:
                self._blocks[h] -= 1

    @property
    def active_blocks(self) -> int:
        return sum(1 for ref in self._blocks.values() if ref > 0)

    @property
    def cached_blocks(self) -> int:
        return len(self._blocks)


class _Seq:
    def __init__(self, req: PreprocessedRequest, ctx: Context, block_size: int):
        self.req = req
        self.ctx = ctx
        # One item per generated token, capped by the request's
        # max_tokens budget in _emit_token.
        self.out_q: asyncio.Queue = asyncio.Queue()
        self.blocks = TokenBlockSequence(block_size, req.token_ids)
        self.generated = 0
        self.prefill_done_at: float | None = None
        self.cached_prefix_blocks = 0
        # Tracing phase boundaries (monotonic).
        self.enqueue_mono = time.monotonic()
        self.prefill_mono: float | None = None
        self.decode_mono: float | None = None


class MockerEngine(AsyncEngine):
    def __init__(self, config: MockerConfig | None = None,
                 kv_publisher=None, metrics_publisher=None,
                 inventory_publisher=None):
        self.config = config or MockerConfig()
        self.kv = KvCacheSim(self.config.num_kv_blocks,
                             self.config.host_blocks)
        self.kv_publisher = kv_publisher
        self.metrics_publisher = metrics_publisher
        self.inventory_publisher = inventory_publisher
        # G4 peer tier (kv_plane.RemoteBlockSource), set by the worker
        # main when a KV plane runs: blocks the fleet holds but this
        # worker lacks are "pulled" (real plane round trip; the sim
        # discards the bytes and counts the block as onboarded).
        self.remote_source = None
        self.waiting: list[_Seq] = []
        self.prefilling: list[_Seq] = []
        self.decoding: list[_Seq] = []
        self._loop_task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self.prefix_hits = 0
        self.prefix_lookups = 0

    def start(self) -> None:
        if self._loop_task is None:
            self._loop_task = asyncio.create_task(self._engine_loop())

    async def stop(self) -> None:
        if self._loop_task:
            self._loop_task.cancel()
            self._loop_task = None

    # -- engine interface -----------------------------------------------------
    async def generate(self, request, context: Context) -> AsyncIterator[dict]:
        self.start()
        req = (request if isinstance(request, PreprocessedRequest)
               else PreprocessedRequest.from_wire(request))
        seq = _Seq(req, context, self.config.block_size)
        self.waiting.append(seq)
        self._wake.set()
        while True:
            item = await seq.out_q.get()
            if item is None:
                return
            yield item
            if item.get("finish_reason"):
                return

    def handler(self):
        async def handle(request, context):
            if isinstance(request, dict) and request.get("embed"):
                raise ValueError("mocker engine does not serve embeddings")
            async for out in self.generate(request, context):
                yield out

        return handle

    # -- simulation loop ------------------------------------------------------
    async def _engine_loop(self) -> None:
        cfg = self.config
        while True:
            if not (self.waiting or self.prefilling or self.decoding):
                self._wake.clear()
                # Idle engine parks until generate() sets the wake event;
                # idling forever with no requests is the contract.
                await self._wake.wait()
            now = time.monotonic()
            if self.remote_source is not None and self.waiting:
                await self._peer_consult()
            self._admit(now)
            # Complete prefills whose simulated time has elapsed.
            for seq in list(self.prefilling):
                if now >= seq.prefill_done_at:
                    self.prefilling.remove(seq)
                    self.decoding.append(seq)
                    rec = get_recorder()
                    if rec.enabled and seq.prefill_mono is not None:
                        rec.add("engine.prefill", seq.ctx.trace_id,
                                seq.ctx.span_id, seq.prefill_mono,
                                time.monotonic(),
                                attrs={"prompt_tokens": len(seq.req.token_ids),
                                       "cached_blocks":
                                       seq.cached_prefix_blocks})
                    seq.decode_mono = time.monotonic()
                    # First token is produced by the prefill itself.
                    self._emit_token(seq)
            # One decode iteration for the whole batch.
            if self.decoding:
                await asyncio.sleep(cfg.decode_time())
                for seq in list(self.decoding):
                    self._emit_token(seq)
            else:
                await asyncio.sleep(cfg.decode_time())
            try:
                await self._flush_events()
                await self._publish_metrics()
                await self._publish_inventory()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — publishing must not
                # kill the simulation loop (requests would hang forever).
                log.warning("mocker publish failed: %s", exc)

    async def _peer_consult(self) -> None:
        """G4 consult for the queue head: the run of blocks past the
        local prefix (G1 + host sim) is fetched from peers over the
        REAL KV plane (executor — the blocking socket round trip must
        not sit on the event loop); fetched blocks inject as reusable
        local blocks so _admit counts them as hits. One consult per
        sequence (the flag), recompute is the silent fallback."""
        seq = self.waiting[0]
        if getattr(seq, "peer_consulted", False):
            return
        seq.peer_consulted = True
        hashes = seq.blocks.block_hashes
        local = 0
        for h in hashes:
            if h in self.kv._blocks or h in self.kv.host:
                local += 1
            else:
                break
        want = hashes[local:]
        if not want:
            return
        loop = asyncio.get_running_loop()
        try:
            fetched = await loop.run_in_executor(
                None, self.remote_source.fetch, want, len(want))
        except Exception:  # noqa: BLE001 — peers are best-effort
            log.warning("mocker peer consult failed", exc_info=True)
            return
        for h, _ in fetched:
            self.kv.inject(h)

    def _admit(self, now: float) -> None:
        cfg = self.config
        while self.waiting and (len(self.prefilling) + len(self.decoding)
                                < cfg.max_num_seqs):
            seq = self.waiting[0]
            if seq.ctx.is_killed:
                self.waiting.pop(0)
                seq.out_q.put_nowait(None)
                continue
            hashes = seq.blocks.block_hashes
            self.prefix_lookups += 1
            cached = self.kv.lookup_prefix(hashes)
            if not self.kv.allocate(hashes):
                break  # no KV room: stays waiting
            if cached:
                self.prefix_hits += 1
            seq.cached_prefix_blocks = cached
            new_tokens = len(seq.req.token_ids) - cached * cfg.block_size
            self.waiting.pop(0)
            rec = get_recorder()
            if rec.enabled:
                rec.add("engine.queue_wait", seq.ctx.trace_id,
                        seq.ctx.span_id, seq.enqueue_mono, time.monotonic())
            seq.prefill_mono = time.monotonic()
            seq.prefill_done_at = now + cfg.prefill_time(max(0, new_tokens))
            self.prefilling.append(seq)

    def _emit_token(self, seq: _Seq) -> None:
        cfg = self.config
        if seq.ctx.is_killed:
            self._finish(seq, None)
            return
        if seq.ctx.is_stopped:
            self._finish(seq, FinishReason.CANCELLED)
            return
        # Deterministic "generation": echo prompt tokens cyclically.
        prompt = seq.req.token_ids or [0]
        token = prompt[seq.generated % len(prompt)]
        new_block = seq.blocks.append(token)
        if new_block is not None:
            self.kv.append_block(new_block)
        seq.generated += 1
        budget = seq.req.stop_conditions.max_tokens or 16
        finish = FinishReason.LENGTH if seq.generated >= budget else None
        seq.out_q.put_nowait(LLMEngineOutput(
            token_ids=[token], finish_reason=finish).to_wire())
        if finish:
            self._finish(seq, None)

    def _finish(self, seq: _Seq, reason: FinishReason | None) -> None:
        if seq in self.decoding:
            self.decoding.remove(seq)
        rec = get_recorder()
        if rec.enabled and seq.decode_mono is not None:
            rec.add("engine.decode", seq.ctx.trace_id, seq.ctx.span_id,
                    seq.decode_mono, time.monotonic(),
                    attrs={"tokens": seq.generated})
            seq.decode_mono = None
        self.kv.release(seq.blocks.block_hashes)
        if reason is not None:
            seq.out_q.put_nowait(LLMEngineOutput(
                token_ids=[], finish_reason=reason).to_wire())
        else:
            seq.out_q.put_nowait(None)

    async def _flush_events(self) -> None:
        if self.kv_publisher is None:
            self.kv.stored_events.clear()
            self.kv.removed_events.clear()
            return
        if self.kv.stored_events:
            stored, self.kv.stored_events = self.kv.stored_events, []
            await self.kv_publisher.stored(stored)
        if self.kv.removed_events:
            removed, self.kv.removed_events = self.kv.removed_events, []
            await self.kv_publisher.removed(removed)

    async def _publish_metrics(self) -> None:
        if self.metrics_publisher is None:
            return
        cfg = self.config
        active = len(self.prefilling) + len(self.decoding)
        hit_rate = (self.prefix_hits / self.prefix_lookups
                    if self.prefix_lookups else 0.0)
        # Force the transition-to-idle publish past the throttle, otherwise
        # routers keep seeing the last busy snapshot forever.
        force = active == 0 and not self.waiting
        await self.metrics_publisher.publish(ForwardPassMetrics(
            worker_stats=WorkerStats(
                request_active_slots=active,
                request_total_slots=cfg.max_num_seqs,
                num_requests_waiting=len(self.waiting)),
            kv_stats=KvStats(
                kv_active_blocks=self.kv.active_blocks,
                kv_total_blocks=cfg.num_kv_blocks,
                gpu_cache_usage_perc=self.kv.active_blocks / cfg.num_kv_blocks,
                gpu_prefix_cache_hit_rate=hit_rate)), force=force)

    # -- KV observability -------------------------------------------------------
    def host_block_provider(self, block_hash: int):
        """KvPlaneServer ``blocks`` provider: serve any block this
        worker holds (G1 or the host sim) to peer pulls, as a tiny
        placeholder parcel (the sim's content is its hash). Runs on a
        plane connection thread — dict lookups racing the loop degrade
        to a miss, never an error."""
        import numpy as np
        try:
            held = (block_hash in self.kv._blocks
                    or block_hash in self.kv.host)
        except RuntimeError:  # mutated mid-lookup: treat as miss
            held = False
        return np.full((2, 1, 1, 8), block_hash & 0xFFFF,
                       np.float32) if held else None

    def inventory_digest(self):
        """Same digest shape the GPU engine publishes, from the
        simulated block pool (fleet-pane tests without hardware). The
        sketch covers the host-tier sim too — the federated router's
        view of blocks that left the radix index on eviction."""
        from dynamo_tpu_torch.llm.kv_router.protocols import (KvInventoryDigest,
                                                        kmin_sketch)
        cfg = self.config
        hashes = list(self.kv._blocks.keys())
        tier_blocks = {"g1": len(hashes)}
        host_hashes = list(self.kv.host.keys())
        if self.kv.host_capacity > 0:
            tier_blocks["g2"] = len(host_hashes)
        return KvInventoryDigest(
            blocks=len(hashes),
            tier_blocks=tier_blocks,
            pages_total=cfg.num_kv_blocks,
            pages_free=cfg.num_kv_blocks - self.kv.active_blocks,
            pages_active=self.kv.active_blocks,
            sketch=kmin_sketch(hashes + host_hashes))

    async def _publish_inventory(self) -> None:
        if self.inventory_publisher is None:
            return
        loop = asyncio.get_running_loop()
        if self.inventory_publisher.due(loop.time()):
            await self.inventory_publisher.publish(self.inventory_digest())

    def kv_status(self) -> dict:
        """The /debug/kv body for a mocker worker."""
        cfg = self.config
        return {
            "role": "mocker",
            "allocator": {
                "pages_total": cfg.num_kv_blocks,
                "pages_free": cfg.num_kv_blocks - self.kv.active_blocks,
                "pages_active": self.kv.active_blocks,
                "pages_inactive": self.kv.cached_blocks
                - self.kv.active_blocks,
                "cached_blocks": self.kv.cached_blocks,
                "occupancy": self.kv.active_blocks / cfg.num_kv_blocks,
                "reuse_hit_blocks": self.prefix_hits,
                "reuse_lookup_blocks": self.prefix_lookups,
            },
            "tiers": ({"g2_blocks": len(self.kv.host),
                       "g2_capacity": self.kv.host_capacity,
                       "g2_spills_in": self.kv.host_spills,
                       "g2_onboards": self.kv.host_onboards}
                      if self.kv.host_capacity > 0 else {}),
            "reuse": {"prefix_hit_blocks": self.prefix_hits,
                      "prefix_lookup_blocks": self.prefix_lookups,
                      "onboard_blocks_peer": self.kv.peer_onboards},
            "plane": None,
            "remote": (self.remote_source.stats()
                       if self.remote_source is not None else None),
            "digest": self.inventory_digest().to_wire(),
        }

    def perf_status(self) -> dict:
        """The /debug/perf body for a mocker worker: the process-global
        registry (empty of device programs: a mocker captures none), so
        the fleet pane's perf merge runs without a card."""
        from dynamo_tpu_torch.engine.perf import get_registry
        reg = get_registry()
        return {"role": "mocker", "compiles": reg.snapshot(),
                "window": reg.window_snapshot(), "hbm": {}, "memory": {},
                "roofline": {"frac": reg.roofline_frac,
                             "expected_frac": None}}
