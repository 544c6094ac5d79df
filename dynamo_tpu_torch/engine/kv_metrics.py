"""dynamo_tpu_kv_* and dynamo_tpu_adapter_* exporters: engine KV and
adapter state -> the metrics registry (copy of
``dynamo_tpu.engine.kv_metrics``).

The engine's KV structures (``PageAllocator``, the host and disk tiers,
the KV plane, the G4 remote source) and the adapter store keep plain-int
telemetry, so the engine thread never takes a metric lock per operation.
These updaters turn it into registered series on a throttle: gauges are
set directly, monotonic ints become counter deltas, so a structure that
restarts (``clear_kv_blocks``) never makes a counter go backwards. Every
series is documented in docs/OBSERVABILITY.md "KV & capacity" and
"Adapters".
"""

from __future__ import annotations

import time

_LAT_BUCKETS = [.001, .005, .01, .025, .05, .1, .25, .5, 1, 2.5]


class KvMetricsUpdater:
    def __init__(self, registry, min_interval_s: float = 0.5):
        self.min_interval_s = min_interval_s
        self._next = 0.0
        self._last: dict[tuple, float] = {}
        self.g_pages = registry.gauge(
            "kv_pages", "HBM KV pages by lifecycle state", ["state"])
        self.g_occupancy = registry.gauge(
            "kv_occupancy", "Fraction of HBM KV pages held by live "
            "sequences")
        self.g_cached_blocks = registry.gauge(
            "kv_cached_blocks", "Registered (reusable) KV blocks in HBM")
        self.g_pool_bytes = registry.gauge(
            "kv_pool_bytes", "Device KV pool bytes at the ACTUAL pool "
            "dtype (int8 pages + scales under --quant-kv, bf16 "
            "otherwise) — halves when the pool quantizes, while kv_pages "
            "doubles at equal HBM budget")
        self.c_reuse = registry.counter(
            "kv_reuse_blocks_total", "Prefix blocks reused instead of "
            "recomputed, by serving tier", ["tier"])
        self.c_reuse_lookup = registry.counter(
            "kv_reuse_lookup_blocks_total", "Prefix blocks probed against "
            "the HBM cache")
        self.c_evicted = registry.counter(
            "kv_evicted_blocks_total", "Inactive HBM blocks LRU-evicted "
            "under allocation pressure")
        self.c_cleared = registry.counter(
            "kv_cleared_blocks_total", "HBM blocks dropped by "
            "clear_inactive (admin clear_kv_blocks)")
        self.g_tier_blocks = registry.gauge(
            "kv_tier_blocks", "Resident KV blocks per offload tier",
            ["tier"])
        self.g_tier_bytes = registry.gauge(
            "kv_tier_bytes", "Approximate bytes per offload tier", ["tier"])
        self.c_tier_hits = registry.counter(
            "kv_tier_hits_total", "Block gets served by an offload tier",
            ["tier"])
        self.c_tier_misses = registry.counter(
            "kv_tier_misses_total", "Block gets that missed an offload "
            "tier", ["tier"])
        self.c_tier_spills = registry.counter(
            "kv_tier_spills_total", "Blocks offloaded into a tier (g2: "
            "HBM evictions; g3: g2 capacity demotions)", ["tier"])
        self.c_plane_pulls = registry.counter(
            "kv_plane_pulls_total", "KV-plane parcel pulls completed by "
            "this worker")
        self.c_plane_pull_seconds = registry.counter(
            "kv_plane_pull_seconds_total", "Wall-clock seconds spent in "
            "KV-plane pulls (rate / pulls rate = mean latency)")
        self.c_plane_bytes = registry.counter(
            "kv_plane_bytes_total", "KV-plane bulk bytes by direction",
            ["direction"])
        self.c_plane_blocks_served = registry.counter(
            "kv_plane_blocks_served_total", "G4 blocks served to peers "
            "from this worker's host tiers")
        # KV federation (engine/kvbm.py; docs/OBSERVABILITY.md "KV
        # federation"): the placement-policy counters, distinct from the
        # mechanism counters above — watermark demotions are proactive
        # (vs kv_evicted_blocks_total's allocation-pressure evictions),
        # promotions count blocks moved UP the ladder into HBM.
        self.c_fed_demotions = registry.counter(
            "kv_federation_demotions_total", "Blocks proactively demoted "
            "by the KVBM watermark sweep (HBM free-list hysteresis)")
        self.c_fed_promotions = registry.counter(
            "kv_federation_promotions_total", "Tier blocks promoted into "
            "HBM pages (host/disk/peer onboards)")
        self.c_fed_recompute = registry.counter(
            "kv_federation_recompute_fallbacks_total", "Tier walks that "
            "ran dry before the request's full prefix (remainder "
            "recomputed — the always-safe fallback)")
        self.c_fed_peer_failures = registry.counter(
            "kv_federation_peer_pull_failures_total", "Peer block pulls "
            "that failed (breaker-open peers, timeouts, transport "
            "errors); the request recomputed instead")
        self.g_fed_pinned = registry.gauge(
            "kv_federation_pinned_blocks", "Blocks pinned against "
            "watermark demotion (KVBM pin set)")
        for tier in ("hbm", "host", "peer"):
            self.c_reuse.ensure(tier=tier)
        for bound in (self.g_occupancy, self.g_cached_blocks,
                      self.g_pool_bytes,
                      self.c_reuse_lookup, self.c_evicted, self.c_cleared,
                      self.c_plane_pulls, self.c_plane_pull_seconds,
                      self.c_plane_blocks_served, self.c_fed_demotions,
                      self.c_fed_promotions, self.c_fed_recompute,
                      self.c_fed_peer_failures, self.g_fed_pinned):
            bound.ensure()

    def _delta(self, bound, key: tuple, current: float, **labels) -> None:
        prev = self._last.get(key, 0.0)
        if current > prev:
            bound.inc(current - prev, **labels)
        self._last[key] = current

    def update(self, engine, force: bool = False) -> None:
        """Engine-thread safe (metric children take a lock, but only
        every ``min_interval_s``). ``engine`` duck-types GPUEngine: needs
        .allocator, .host_cache, .onboard_blocks, .g4_blocks, and
        optionally .plane / .remote_source set by the worker main."""
        now = time.monotonic()
        if not force and now < self._next:
            return
        self._next = now + self.min_interval_s
        alloc = engine.allocator.stats()
        self.g_pages.set(alloc["pages_free"], state="free")
        self.g_pages.set(alloc["pages_active"], state="active")
        self.g_pages.set(alloc["pages_inactive"], state="inactive")
        self.g_occupancy.set(alloc["occupancy"])
        self.g_cached_blocks.set(alloc["cached_blocks"])
        runner = getattr(engine, "runner", None)
        if runner is not None:
            self.g_pool_bytes.set(getattr(runner, "kv_pool_bytes", 0))
        self._delta(self.c_reuse_lookup, ("lookup",),
                    alloc["reuse_lookup_blocks"])
        self._delta(self.c_evicted, ("evicted",), alloc["evicted_blocks"])
        self._delta(self.c_cleared, ("cleared",), alloc["cleared_blocks"])
        # Reuse attribution by tier: HBM hits from the allocator, host
        # (G2/G3) vs peer (G4) from the engine's onboard counters.
        g4 = getattr(engine, "g4_blocks", 0)
        onboard = getattr(engine, "onboard_blocks", 0)
        self._delta(self.c_reuse, ("reuse", "hbm"),
                    alloc["reuse_hit_blocks"], tier="hbm")
        self._delta(self.c_reuse, ("reuse", "host"), onboard - g4,
                    tier="host")
        self._delta(self.c_reuse, ("reuse", "peer"), g4, tier="peer")
        host = getattr(engine, "host_cache", None)
        if host is not None:
            tiers = host.stats()
            for tier in ("g2", "g3"):
                if f"{tier}_blocks" not in tiers:
                    continue
                self.g_tier_blocks.set(tiers[f"{tier}_blocks"], tier=tier)
                self.g_tier_bytes.set(tiers.get(f"{tier}_bytes", 0),
                                      tier=tier)
                self._delta(self.c_tier_hits, ("hits", tier),
                            tiers[f"{tier}_hits"], tier=tier)
                self._delta(self.c_tier_misses, ("misses", tier),
                            tiers[f"{tier}_misses"], tier=tier)
            self._delta(self.c_tier_spills, ("spills", "g2"),
                        tiers.get("g2_spills_in", 0), tier="g2")
            self._delta(self.c_tier_spills, ("spills", "g3"),
                        tiers.get("g2_demotions", 0), tier="g3")
        kvbm = getattr(engine, "kvbm", None)
        if kvbm is not None:
            self._delta(self.c_fed_demotions, ("fed_demote",),
                        kvbm.watermark_demotions)
            self._delta(self.c_fed_promotions, ("fed_promote",),
                        kvbm.promotions)
            self._delta(self.c_fed_recompute, ("fed_recompute",),
                        kvbm.recompute_fallbacks)
            self._delta(self.c_fed_peer_failures, ("fed_peer_fail",),
                        kvbm.peer_pull_failures)
            self.g_fed_pinned.set(len(kvbm.pinned))
        remote = getattr(engine, "remote_source", None)
        if remote is not None:
            self._delta(self.c_fed_peer_failures, ("peer_fetch_fail",),
                        remote.fetch_failures)
            client = remote.client
            self._delta(self.c_plane_pulls, ("pulls",), client.transfers)
            self._delta(self.c_plane_pull_seconds, ("pull_s",),
                        client.pull_seconds_total)
            self._delta(self.c_plane_bytes, ("bytes", "in"),
                        client.bytes_in, direction="in")
        plane = getattr(engine, "plane", None)
        if plane is not None:
            self._delta(self.c_plane_bytes, ("bytes", "out"),
                        plane.bytes_out, direction="out")
            self._delta(self.c_plane_blocks_served, ("served",),
                        plane.blocks_served)


class AdapterMetricsUpdater:
    """dynamo_tpu_adapter_* exporter (engine/lora.py AdapterStore ->
    Prometheus, same discipline as KvMetricsUpdater: the store keeps
    plain ints, gauges set directly, monotonic ints become counter
    deltas on a throttle). Documented in docs/OBSERVABILITY.md
    "Adapters"."""

    def __init__(self, registry, min_interval_s: float = 0.5):
        self.min_interval_s = min_interval_s
        self._next = 0.0
        self._last: dict[tuple, float] = {}
        self.g_resident = registry.gauge(
            "adapter_resident", "LoRA adapters currently resident in "
            "device slots (hot; excludes host-registered-only adapters)")
        self.c_loads = registry.counter(
            "adapter_loads_total", "Adapter device uploads (cold first "
            "loads + hot-reloads after eviction)")
        self.c_evictions = registry.counter(
            "adapter_evictions_total", "Adapter slot evictions (LRU "
            "pressure + explicit admin evicts)")
        self.c_miss = registry.counter(
            "adapter_miss_total", "Requests that arrived while their "
            "adapter was NOT resident (each forces a hot-load — a high "
            "rate is an adapter-miss storm: raise --max-adapters or pin)")
        self.c_requests = registry.counter(
            "adapter_requests_total", "Requests resolved per adapter "
            "name", ["adapter"])
        for bound in (self.g_resident, self.c_loads, self.c_evictions,
                      self.c_miss):
            bound.ensure()

    def _delta(self, bound, key: tuple, current: float, **labels) -> None:
        prev = self._last.get(key, 0.0)
        if current > prev:
            bound.inc(current - prev, **labels)
        self._last[key] = current

    def update(self, store, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now < self._next:
            return
        self._next = now + self.min_interval_s
        self.g_resident.set(store.resident)
        self._delta(self.c_loads, ("loads",), store.loads_total)
        self._delta(self.c_evictions, ("evictions",), store.evictions_total)
        self._delta(self.c_miss, ("miss",), store.miss_total)
        for name, n in store.requests_total.items():
            self._delta(self.c_requests, ("req", name), n, adapter=name)
