"""KV-router wire protocols (dataclass copies of the pydantic models in
``dynamo_tpu.llm.kv_router.protocols``): cache events, worker load
metrics and fleet inventory digests.

``to_wire`` writes the dict pydantic's ``model_dump`` writes for the same
object, nested dicts and ``None`` fields included (``ForwardPassMetrics``
drops its ``None`` fields, as the reference's ``exclude_none`` does), so
JAX and port workers and routers share the coordinator's subjects.
``from_wire`` reads what either package sends and ignores keys it does not
know, as pydantic does by default.
"""

from __future__ import annotations

import dataclasses
import heapq

#: k-min sketch size: 64 minima of the 64-bit hash space estimate overlap
#: between two workers' inventories to ~±12% — plenty for an operator pane.
SKETCH_K = 64
_HASH_MASK = (1 << 64) - 1


def kmin_sketch(hashes, k: int = SKETCH_K) -> list[int]:
    """The k smallest 64-bit-normalized block hashes: a fixed-size,
    mergeable summary of a hash set (k-minimum-values sketch)."""
    return heapq.nsmallest(k, (h & _HASH_MASK for h in hashes))


def sketch_overlap(a: list[int], b: list[int], k: int = SKETCH_K) -> float:
    """Estimated Jaccard overlap of the two sketched hash sets: the
    fraction of the merged k smallest values present in both sketches."""
    if not a or not b:
        return 0.0
    merged = heapq.nsmallest(min(k, len(a) + len(b)), set(a) | set(b))
    sa, sb = set(a), set(b)
    inter = sum(1 for h in merged if h in sa and h in sb)
    return inter / len(merged)


def sketch_prefix_blocks(sketch: list[int],
                         block_hashes: list[int]) -> int:
    """How many of a request's leading block hashes a sketched inventory
    provably holds — the federated-routing overlap estimate.

    Sound by construction: a k-min sketch stores ACTUAL hash values, so
    membership has no false positives. With at most k blocks the sketch
    is the whole inventory and this is the exact longest-prefix match;
    with more, a miss is inconclusive, so the walk stops at the first
    miss and the result is a lower bound."""
    if not sketch or not block_hashes:
        return 0
    members = set(sketch)
    n = 0
    for h in block_hashes:
        if (h & _HASH_MASK) in members:
            n += 1
        else:
            break
    return n


def _known(cls, data: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in data.items() if k in names}


def _floats(obj, *names: str):
    # pydantic's lax mode reads an int sent for a float field as a float.
    for name in names:
        setattr(obj, name, float(getattr(obj, name)))
    return obj


class _Wire:
    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, data: dict):
        return cls(**_known(cls, data))


@dataclasses.dataclass
class KvStoredBlock(_Wire):
    block_hash: int
    # tokens are optional diagnostics; the hash is authoritative.
    parent_hash: int | None = None


@dataclasses.dataclass
class KvCacheEvent(_Wire):
    """stored | removed | cleared."""

    kind: str  # "stored" | "removed" | "cleared"
    event_id: int = 0
    parent_hash: int | None = None  # for stored: parent of the first block
    block_hashes: list[int] = dataclasses.field(default_factory=list)

    @classmethod
    def stored(cls, block_hashes: list[int], parent_hash: int | None = None,
               event_id: int = 0) -> "KvCacheEvent":
        return cls(event_id=event_id, kind="stored", parent_hash=parent_hash,
                   block_hashes=block_hashes)

    @classmethod
    def removed(cls, block_hashes: list[int],
                event_id: int = 0) -> "KvCacheEvent":
        return cls(event_id=event_id, kind="removed",
                   block_hashes=block_hashes)

    @classmethod
    def cleared(cls, event_id: int = 0) -> "KvCacheEvent":
        return cls(event_id=event_id, kind="cleared")

    def to_wire(self) -> dict:
        # The reference's field order.
        return {"event_id": self.event_id, "kind": self.kind,
                "parent_hash": self.parent_hash,
                "block_hashes": list(self.block_hashes)}

    @classmethod
    def from_wire(cls, data: dict) -> "KvCacheEvent":
        ev = cls(**_known(cls, data))
        ev.block_hashes = list(ev.block_hashes)
        return ev


@dataclasses.dataclass
class RouterEvent(_Wire):
    worker_id: int
    event: KvCacheEvent

    def to_wire(self) -> dict:
        return {"worker_id": self.worker_id, "event": self.event.to_wire()}

    @classmethod
    def from_wire(cls, data: dict) -> "RouterEvent":
        return cls(worker_id=data["worker_id"],
                   event=KvCacheEvent.from_wire(data["event"]))


@dataclasses.dataclass
class WorkerStats(_Wire):
    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0
    data_parallel_rank: int | None = None


@dataclasses.dataclass
class KvStats(_Wire):
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0

    @classmethod
    def from_wire(cls, data: dict) -> "KvStats":
        return _floats(cls(**_known(cls, data)), "gpu_cache_usage_perc",
                       "gpu_prefix_cache_hit_rate")


@dataclasses.dataclass
class SpecDecodeStats(_Wire):
    num_spec_tokens: int = 0
    num_drafts: int = 0
    num_accepted_tokens: int = 0


@dataclasses.dataclass
class ForwardPassMetrics(_Wire):
    """Published by workers after engine iterations."""

    worker_id: int = 0
    worker_stats: WorkerStats = dataclasses.field(default_factory=WorkerStats)
    kv_stats: KvStats = dataclasses.field(default_factory=KvStats)
    spec_decode_stats: SpecDecodeStats | None = None

    def to_wire(self) -> dict:
        out = {"worker_id": self.worker_id,
               "worker_stats": {k: v for k, v in
                                self.worker_stats.to_wire().items()
                                if v is not None},
               "kv_stats": self.kv_stats.to_wire()}
        if self.spec_decode_stats is not None:
            out["spec_decode_stats"] = self.spec_decode_stats.to_wire()
        return out

    @classmethod
    def from_wire(cls, data: dict) -> "ForwardPassMetrics":
        spec = data.get("spec_decode_stats")
        return cls(
            worker_id=data.get("worker_id", 0),
            worker_stats=WorkerStats.from_wire(data.get("worker_stats")
                                               or {}),
            kv_stats=KvStats.from_wire(data.get("kv_stats") or {}),
            spec_decode_stats=(None if spec is None
                               else SpecDecodeStats.from_wire(spec)))


@dataclasses.dataclass
class KvInventoryDigest(_Wire):
    """Periodic per-worker KV inventory summary (worker -> router): block
    counts per tier, capacity headroom and a k-min sketch of the hashes,
    never the full hash list. ``seq`` is a per-worker monotonic counter so
    consumers can drop reordered digests; ``ts`` is the publisher's wall
    clock."""

    worker_id: int = 0
    seq: int = 0
    ts: float = 0.0
    # Resident registered blocks on the device (G1) and blocks per tier.
    blocks: int = 0
    tier_blocks: dict[str, int] = dataclasses.field(default_factory=dict)
    pages_total: int = 0
    pages_free: int = 0
    pages_active: int = 0
    sketch: list[int] = dataclasses.field(default_factory=list)

    @classmethod
    def from_wire(cls, data: dict) -> "KvInventoryDigest":
        digest = _floats(cls(**_known(cls, data)), "ts")
        digest.tier_blocks = dict(digest.tier_blocks)
        digest.sketch = list(digest.sketch)
        return digest


# Subjects on the coordinator pub/sub plane (reference kv_router.rs:56-65).
def kv_events_subject(namespace: str, component: str) -> str:
    return f"ns.{namespace}.cp.{component}.kv_events"


def load_metrics_subject(namespace: str, component: str) -> str:
    return f"ns.{namespace}.cp.{component}.load_metrics"


def router_sync_subject(namespace: str, component: str) -> str:
    """Inter-replica router state sync (reference kv_router.rs:64-65)."""
    return f"ns.{namespace}.cp.{component}.router_sync"


def kv_inventory_subject(namespace: str, component: str) -> str:
    """Fleet inventory digests (KvInventoryDigest), alongside kv_events
    and load_metrics on the event plane."""
    return f"ns.{namespace}.cp.{component}.kv_inventory"
