"""KVBM: the policy for KV block placement across tiers (copy of
``dynamo_tpu.engine.kvbm``).

``KvBlockManager`` makes the tier decisions over the mechanism objects
(``PageAllocator``, ``HostKVCache`` with its ``DiskKVCache``, and the G4
``RemoteBlockSource`` of ``llm/kv_plane.py``):

- **Watermark demotion** (``maintain``): while the device pool's free
  list is below ``low_watermark`` of the pool, each sweep demotes LRU
  inactive blocks to the host tier, aiming at ``high_watermark`` but at
  most ``max_demotions_per_sweep`` a sweep, so the pool settles just
  above ``low`` (the reference's policy). An allocation burst then finds
  pages on the free list instead of paying for eviction inside the
  allocation.
- **Pins**: ACTIVE pages are never demotable (the allocator's lifecycle
  invariant), and ``pin`` also protects registered but inactive blocks
  (a fleet-shared system prompt) from the watermark sweep.
- **Promote-on-hit**: a hit in a lower tier moves the block up (disk to
  DRAM inside ``HostKVCache.get``; host or peer to the device pool by the
  engine's upload; peer blocks also land in the local G2).
- **The tier walk** (``onboard_walk``): host and disk first, then one
  bounded consult of the peers (G4), falling back to recompute, never
  failing the request.

``status`` is the one occupancy and counter surface. The manager does no
device work: extracts and uploads stay in the engine, whose thread owns
the runner; KVBM decides what moves where. Demotion sweeps and promotions
are journaled (``kv_demote``, ``kv_promote``, at most one event per kind
per ``journal_min_interval_s``) with a cause ref, so ``/debug/timeline``
shows tier movement beside the preemptions and peer pulls behind it.
"""

from __future__ import annotations

import dataclasses
import time

from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("kvbm")


@dataclasses.dataclass
class KvbmPolicy:
    """Tier policy knobs (``EngineConfig.kvbm_policy()``). The tiers'
    budgets live on EngineConfig and HostKVCache; this object holds the
    decisions layered on them."""

    # Free-list watermarks as fractions of the device pool. A sweep runs
    # while len(free) / num_pages < low and demotes toward high, at most
    # max_demotions_per_sweep blocks. 0 disables proactive demotion:
    # eviction then only happens under allocation pressure.
    low_watermark: float = 0.0
    high_watermark: float = 0.0
    # At most this many blocks demoted per maintain() call: the sweep runs
    # on the engine thread between windows, and each demotion queues an
    # extract.
    max_demotions_per_sweep: int = 16
    # At most one kv_demote / kv_promote journal event per this many
    # seconds per kind: tier churn is per block, the timeline wants one
    # event per burst.
    journal_min_interval_s: float = 1.0

    def __post_init__(self):
        if self.low_watermark and not self.high_watermark:
            self.high_watermark = min(1.0, self.low_watermark + 0.05)
        if self.high_watermark < self.low_watermark:
            raise ValueError(
                f"kv watermarks inverted: high {self.high_watermark} < "
                f"low {self.low_watermark}")


class KvBlockManager:
    """Placement and eviction policy across device pool, host, disk and
    peers. ENGINE THREAD ONLY for ``maintain``/``onboard_walk``;
    ``pin``/``unpin``/``status`` are safe from any thread."""

    def __init__(self, allocator, host_cache=None,
                 policy: KvbmPolicy | None = None):
        self.allocator = allocator
        self.host_cache = host_cache
        self.policy = policy or KvbmPolicy()
        # The G4 tier, set by the worker once its KV plane is up
        # (``GPUEngine.remote_source`` delegates here).
        self.remote_source = None
        # Registered but inactive blocks the sweep must not demote.
        self.pinned: set[int] = set()
        self.watermark_demotions = 0
        self.demotion_sweeps = 0
        self.promotions = 0           # blocks moved up a tier (any rung)
        self.peer_pull_blocks = 0
        self.peer_pull_failures = 0
        self.recompute_fallbacks = 0  # tier walk ended short of the goal
        self.pinned_skips = 0         # sweeps that pins held back
        self._journal_next: dict[str, float] = {}

    # -- pinning --------------------------------------------------------------
    def pin(self, block_hashes) -> None:
        self.pinned.update(block_hashes)

    def unpin(self, block_hashes) -> None:
        self.pinned.difference_update(block_hashes)

    # -- watermark demotion ---------------------------------------------------
    def free_fraction(self) -> float:
        alloc = self.allocator
        return (len(alloc.free) / alloc.num_pages) if alloc.num_pages else 1.0

    def maintain(self) -> int:
        """One engine-loop sweep: demote LRU inactive blocks while the free
        list is under the low watermark, up to the high watermark, the
        sweep budget or the inactive pool. The evict hook queues their
        extracts; the engine's ``_flush_spills`` dispatches them. Returns
        the blocks demoted."""
        p = self.policy
        if not p.low_watermark or self.host_cache is None:
            return 0
        alloc = self.allocator
        if self.free_fraction() >= p.low_watermark:
            return 0
        target = int(p.high_watermark * alloc.num_pages)
        want = min(p.max_demotions_per_sweep,
                   max(0, target - len(alloc.free)))
        if want <= 0:
            return 0
        before = len(alloc.inactive)
        took = len(alloc.demote_lru(want, skip=self.pinned))
        # Count a pinned pass only when pins held the sweep back (inactive
        # entries remained that demote_lru skipped).
        if took < want and before - took > 0 and self.pinned:
            self.pinned_skips += 1
        if took:
            self.watermark_demotions += took
            self.demotion_sweeps += 1
            if self._journal_due("demote"):
                journal.emit(
                    EventKind.KV_DEMOTE, blocks=took,
                    tier_from="g1", tier_to="g2",
                    free_frac=round(self.free_fraction(), 4),
                    cause=journal.recent_ref(EventKind.KV_DEMOTE,
                                             EventKind.PREEMPT))
        return took

    # -- tier walk (host -> disk -> peer) -------------------------------------
    def onboard_walk(self, hashes: list[int], start: int, allowed: int,
                     trace_id: str | None = None):
        """Collect up to ``allowed`` consecutive blocks from
        ``hashes[start]`` on out of the tiers below the device pool.
        Returns (blocks [(hash, parcel)], n_peer): host and disk first
        (``HostKVCache.get`` promotes a disk hit to DRAM), then one bounded
        peer consult for the rest. The engine uploads them into pages: that
        upload is the promotion to G1."""
        blocks: list[tuple[int, object]] = []
        if self.host_cache is not None:
            for h in hashes[start:]:
                if len(blocks) >= allowed:
                    break
                kv = self.host_cache.get(h)
                if kv is None:
                    break
                blocks.append((h, kv))
        n_peer = 0
        if self.remote_source is not None and len(blocks) < allowed:
            at = start + len(blocks)
            want = hashes[at:at + (allowed - len(blocks))]
            if want:
                try:
                    remote = self.remote_source.fetch(
                        want, len(want), trace_id=trace_id)
                except Exception:  # noqa: BLE001 — peers are best-effort
                    log.exception("G4 remote fetch failed")
                    self.peer_pull_failures += 1
                    remote = []
                blocks.extend(remote)
                n_peer = len(remote)
                self.peer_pull_blocks += n_peer
        if len(blocks) < allowed:
            # The ladder ran dry before the request's whole prefix: the
            # rest recomputes.
            self.recompute_fallbacks += 1
        return blocks, n_peer

    def note_promoted(self, n_host: int, n_peer: int,
                      trace_id: str | None = None) -> None:
        """The engine uploaded ``n_host + n_peer`` tier blocks into device
        pages (promote-on-hit completing): counted and journaled, the peer
        share caused by the pull that sourced it."""
        n = n_host + n_peer
        if n <= 0:
            return
        self.promotions += n
        if self._journal_due("promote"):
            journal.emit(
                EventKind.KV_PROMOTE, blocks=n, peer_blocks=n_peer,
                tier_to="g1", trace_id=trace_id,
                cause=journal.recent_ref(EventKind.KV_PEER_PULL,
                                         EventKind.KV_DEMOTE))

    def _journal_due(self, key: str) -> bool:
        """Per-kind journal throttle."""
        now = time.monotonic()
        if now < self._journal_next.get(key, 0.0):
            return False
        self._journal_next[key] = now + self.policy.journal_min_interval_s
        return True

    def offload(self, block_hash: int, kv) -> None:
        """Store one extracted block in the host tier (a demotion's data
        movement, from the engine's spill resolution)."""
        if self.host_cache is not None:
            self.host_cache.put(block_hash, kv)

    # -- observability --------------------------------------------------------
    def status(self) -> dict:
        """Policy, pins, counters and per-tier occupancy, consistent with
        the tiers' own stats."""
        alloc = self.allocator
        tiers = {"g1": {"blocks": len(alloc.cached),
                        "pages_free": len(alloc.free),
                        "pages_inactive": len(alloc.inactive),
                        "capacity": alloc.num_pages}}
        if self.host_cache is not None:
            hs = self.host_cache.stats()
            tiers["g2"] = {"blocks": hs["g2_blocks"],
                           "capacity": hs["g2_capacity"]}
            if "g3_blocks" in hs:
                tiers["g3"] = {"blocks": hs["g3_blocks"],
                               "capacity": hs["g3_capacity"]}
        if self.remote_source is not None:
            rs = self.remote_source.stats()
            tiers["peer"] = {"peers": rs["peers"],
                             "fetched_blocks": rs["fetched_blocks"]}
        return {
            "policy": {
                "low_watermark": self.policy.low_watermark,
                "high_watermark": self.policy.high_watermark,
                "max_demotions_per_sweep":
                    self.policy.max_demotions_per_sweep,
            },
            "free_fraction": round(self.free_fraction(), 4),
            "pinned_blocks": len(self.pinned),
            "tiers": tiers,
            "watermark_demotions": self.watermark_demotions,
            "demotion_sweeps": self.demotion_sweeps,
            "promotions": self.promotions,
            "peer_pull_blocks": self.peer_pull_blocks,
            "peer_pull_failures": self.peer_pull_failures,
            "recompute_fallbacks": self.recompute_fallbacks,
            "pinned_skips": self.pinned_skips,
        }
