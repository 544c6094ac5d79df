"""Router-side fleet KV state (copy of ``dynamo_tpu.llm.kv_router.fleet``):
inventory digests and decision telemetry, two synchronous cores that the
KV router's loops feed.

- ``FleetInventory``: the latest KvInventoryDigest per worker, with
  staleness and pairwise overlap estimated from the hash sketches.
- ``DecisionLog``: per routing decision, the chosen worker's overlap
  against the best available overlap. A persistent gap means load is
  overriding cache affinity.
"""

from __future__ import annotations

import collections
import time

from dynamo_tpu_torch.llm.kv_router.protocols import (KvInventoryDigest,
                                                      sketch_overlap,
                                                      sketch_prefix_blocks)

#: A digest older than this is reported stale (worker dead or its
#: publisher wedged); the prune loop removes the worker soon after.
STALE_S = 30.0


class FleetInventory:
    def __init__(self, stale_s: float = STALE_S):
        self.stale_s = stale_s
        # worker_id -> (received monotonic time, digest)
        self._digests: dict[int, tuple[float, KvInventoryDigest]] = {}
        self.applied = 0
        self.dropped_stale_seq = 0

    def apply(self, digest: KvInventoryDigest) -> bool:
        """Apply one digest; False when a reordered (older-seq) digest
        for the same worker was dropped."""
        prev = self._digests.get(digest.worker_id)
        if prev is not None and digest.seq <= prev[1].seq:
            self.dropped_stale_seq += 1
            return False
        self._digests[digest.worker_id] = (time.monotonic(), digest)
        self.applied += 1
        return True

    def remove_worker(self, worker_id: int) -> None:
        self._digests.pop(worker_id, None)

    def workers(self) -> set[int]:
        return set(self._digests)

    def digest(self, worker_id: int) -> KvInventoryDigest | None:
        entry = self._digests.get(worker_id)
        return entry[1] if entry else None

    def prefix_overlap(self, worker_id: int,
                       block_hashes: list[int]) -> int:
        """How many of the request's leading blocks this worker's
        inventory provably holds; a stale digest scores 0."""
        entry = self._digests.get(worker_id)
        if entry is None:
            return 0
        t, digest = entry
        if time.monotonic() - t > self.stale_s:
            return 0
        return sketch_prefix_blocks(digest.sketch, block_hashes)

    def prefix_overlaps(self, workers, block_hashes: list[int]):
        """Per-worker federated overlap (the shape of OverlapScores);
        zero scores are omitted."""
        out: dict[int, int] = {}
        for w in workers:
            n = self.prefix_overlap(w, block_hashes)
            if n > 0:
                out[w] = n
        return out

    def overlap_matrix(self) -> dict[str, float]:
        """Pairwise sketch-estimated inventory overlap, keyed
        "workerhex:workerhex"."""
        items = [(w, d.sketch) for w, (_, d) in self._digests.items()
                 if d.sketch]
        out: dict[str, float] = {}
        for i, (wa, sa) in enumerate(items):
            for wb, sb in items[i + 1:]:
                out[f"{wa:x}:{wb:x}"] = round(sketch_overlap(sa, sb), 4)
        return out

    def snapshot(self) -> dict:
        """Per-worker inventory, capacity and staleness, fleet totals and
        the overlap matrix."""
        now = time.monotonic()
        workers: dict[str, dict] = {}
        tot_blocks = tot_pages = tot_free = tot_active = 0
        stale = 0
        for worker_id, (t, d) in sorted(self._digests.items()):
            age = now - t
            is_stale = age > self.stale_s
            stale += is_stale
            workers[f"{worker_id:x}"] = {
                "blocks": d.blocks, "tier_blocks": d.tier_blocks,
                "pages_total": d.pages_total, "pages_free": d.pages_free,
                "pages_active": d.pages_active,
                "headroom": (d.pages_free / d.pages_total
                             if d.pages_total else 0.0),
                "seq": d.seq, "age_s": round(age, 3), "stale": is_stale,
            }
            if not is_stale:
                tot_blocks += d.blocks
                tot_pages += d.pages_total
                tot_free += d.pages_free
                tot_active += d.pages_active
        return {
            "workers": workers,
            "totals": {"workers": len(workers), "stale": stale,
                       "blocks": tot_blocks, "pages_total": tot_pages,
                       "pages_free": tot_free, "pages_active": tot_active},
            "overlap": self.overlap_matrix(),
            "applied": self.applied,
            "dropped_stale_seq": self.dropped_stale_seq,
        }


def _percentile(sorted_vals: list, q: float):
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * q))]


class DecisionLog:
    """Bounded ring of routing decisions: chosen vs best overlap."""

    def __init__(self, capacity: int = 512):
        self._ring: collections.deque[tuple[int, int, int, int]] = \
            collections.deque(maxlen=capacity)
        self.decisions = 0
        self.cache_aware = 0    # chosen overlap == best available overlap
        self.regret_blocks = 0  # cumulative best - chosen

    def note(self, worker_id: int, chosen_overlap: int, best_overlap: int,
             request_blocks: int) -> None:
        self.decisions += 1
        if chosen_overlap >= best_overlap:
            self.cache_aware += 1
        self.regret_blocks += max(0, best_overlap - chosen_overlap)
        self._ring.append((worker_id, chosen_overlap, best_overlap,
                           request_blocks))

    def snapshot(self) -> dict:
        rows = list(self._ring)
        chosen = sorted(c for _, c, _, _ in rows)
        best = sorted(b for _, _, b, _ in rows)
        regret = sorted(max(0, b - c) for _, c, b, _ in rows)
        return {
            "decisions": self.decisions,
            "cache_aware": self.cache_aware,
            "cache_aware_rate": (self.cache_aware / self.decisions
                                 if self.decisions else None),
            "regret_blocks_total": self.regret_blocks,
            "window": len(rows),
            "chosen_overlap_p50": _percentile(chosen, 0.50),
            "chosen_overlap_p99": _percentile(chosen, 0.99),
            "best_overlap_p50": _percentile(best, 0.50),
            "best_overlap_p99": _percentile(best, 0.99),
            "regret_p50": _percentile(regret, 0.50),
            "regret_p99": _percentile(regret, 0.99),
            "recent": [
                {"worker": f"{w:x}", "chosen": c, "best": b, "blocks": n}
                for w, c, b, n in rows[-20:]],
        }
