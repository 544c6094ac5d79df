"""Radix index of cached KV blocks per worker (copy of
``dynamo_tpu.llm.kv_router.indexer``).

Block hashes chain their full prefix (``llm/tokens.py``), so the radix
structure is implicit in the hashes: the index maps block_hash -> set of
workers that hold it, and longest-prefix matching walks the request's
block hashes in order, narrowing the worker set. Events arrive from
workers (stored/removed/cleared); a worker's death removes all its blocks.
The reference prefers its native C++ tree when it is built; the port keeps
the Python tree only (``RadixTree`` is ``PyRadixTree``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Iterable

from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent
from dynamo_tpu_torch.llm.tokens import compute_block_hashes

OverlapScores = dict[int, int]  # worker_id -> number of matched prefix blocks


class PyRadixTree:
    def __init__(self):
        # block_hash -> set of worker ids holding the block.
        self._blocks: dict[int, set[int]] = {}
        # worker_id -> set of block hashes (for remove_worker).
        self._by_worker: dict[int, set[int]] = defaultdict(set)
        self.event_count = 0

    def apply_event(self, event: RouterEvent) -> None:
        self.event_count += 1
        worker = event.worker_id
        ev = event.event
        if ev.kind == "stored":
            for h in ev.block_hashes:
                self._blocks.setdefault(h, set()).add(worker)
                self._by_worker[worker].add(h)
        elif ev.kind == "removed":
            for h in ev.block_hashes:
                workers = self._blocks.get(h)
                if workers is not None:
                    workers.discard(worker)
                    if not workers:
                        del self._blocks[h]
                self._by_worker[worker].discard(h)
        elif ev.kind == "cleared":
            self.remove_worker(worker)

    def remove_worker(self, worker_id: int) -> None:
        for h in self._by_worker.pop(worker_id, set()):
            workers = self._blocks.get(h)
            if workers is not None:
                workers.discard(worker_id)
                if not workers:
                    del self._blocks[h]

    def find_matches(self, block_hashes: Iterable[int]) -> OverlapScores:
        """Longest-prefix overlap per worker: a worker scores i+1 only if it
        holds blocks 0..i contiguously."""
        scores: OverlapScores = {}
        active: set[int] | None = None
        for h in block_hashes:
            holders = self._blocks.get(h)
            if not holders:
                break
            active = set(holders) if active is None else active & holders
            if not active:
                break
            for w in active:
                scores[w] = scores.get(w, 0) + 1
        return scores

    def dump_as_events(self) -> list[RouterEvent]:
        """The state as stored events, for a new router replica."""
        out = []
        for worker, hashes in self._by_worker.items():
            if hashes:
                out.append(RouterEvent(
                    worker_id=worker,
                    event=KvCacheEvent.stored(sorted(hashes))))
        return out

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    def workers(self) -> set[int]:
        return {w for w, hs in self._by_worker.items() if hs}


RadixTree = PyRadixTree


class KvIndexer:
    """The synchronous core of a component's kv_events index; the
    subscription loop lives in the router."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.tree = RadixTree()

    def apply(self, event: RouterEvent) -> None:
        self.tree.apply_event(event)

    def find_matches_for_tokens(self, token_ids: list[int]) -> OverlapScores:
        return self.tree.find_matches(
            compute_block_hashes(token_ids, self.block_size))


class ApproxKvIndexer:
    """TTL-based approximation for engines that emit no KV events: on
    every routing decision the chosen worker is assumed to hold the
    request's prefix blocks for ``ttl_s``."""

    def __init__(self, block_size: int, ttl_s: float = 120.0):
        self.block_size = block_size
        self.ttl_s = ttl_s
        self.tree = RadixTree()
        self._expiry: list[tuple[float, int, list[int]]] = []
        # Authoritative per-(worker, block) deadline: a re-touch extends
        # it, so an older expiry entry must not remove refreshed blocks.
        self._deadline: dict[tuple[int, int], float] = {}

    def touch(self, worker_id: int, token_ids: list[int]) -> None:
        # Every mutation sweeps the expiry head first, so stale entries
        # never outlive ttl_s for a caller that only touches.
        self.purge()
        hashes = compute_block_hashes(token_ids, self.block_size)
        if not hashes:
            return
        deadline = time.monotonic() + self.ttl_s
        self.tree.apply_event(RouterEvent(
            worker_id=worker_id, event=KvCacheEvent.stored(hashes)))
        for h in hashes:
            self._deadline[(worker_id, h)] = deadline
        self._expiry.append((deadline, worker_id, hashes))

    def purge(self) -> None:
        now = time.monotonic()
        while self._expiry and self._expiry[0][0] <= now:
            _, worker, hashes = self._expiry.pop(0)
            expired = [h for h in hashes
                       if self._deadline.get((worker, h), 0.0) <= now]
            for h in expired:
                self._deadline.pop((worker, h), None)
            if expired:
                self.tree.apply_event(RouterEvent(
                    worker_id=worker, event=KvCacheEvent.removed(expired)))

    def find_matches_for_tokens(self, token_ids: list[int]) -> OverlapScores:
        self.purge()
        return self.tree.find_matches(
            compute_block_hashes(token_ids, self.block_size))
