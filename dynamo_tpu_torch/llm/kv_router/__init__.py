"""KV-cache-aware routing (copy of ``dynamo_tpu.llm.kv_router``): a radix
index of block hashes per worker fed by the workers' KV events, a
scheduler that costs overlap-weighted prefill work against load, an
optimistic in-flight ledger shared between router replicas, an
approximate TTL indexer, worker load metrics and fleet inventory
digests. The messages are the JAX package's dicts, so JAX and port
workers and routers mix in one fleet.
"""

from dynamo_tpu_torch.llm.kv_router.fleet import DecisionLog, FleetInventory
from dynamo_tpu_torch.llm.kv_router.indexer import (KvIndexer, OverlapScores,
                                                    RadixTree)
from dynamo_tpu_torch.llm.kv_router.protocols import (ForwardPassMetrics,
                                                      KvCacheEvent,
                                                      KvInventoryDigest,
                                                      KvStats, RouterEvent,
                                                      WorkerStats)
from dynamo_tpu_torch.llm.kv_router.publisher import (KvEventPublisher,
                                                      KvInventoryPublisher,
                                                      WorkerMetricsPublisher)
from dynamo_tpu_torch.llm.kv_router.router import (KvPushRouter,
                                                   make_kv_router_factory)
from dynamo_tpu_torch.llm.kv_router.scheduler import (KvRouterConfig,
                                                      KvScheduler)

__all__ = [
    "DecisionLog",
    "FleetInventory",
    "ForwardPassMetrics",
    "KvCacheEvent",
    "KvEventPublisher",
    "KvIndexer",
    "KvInventoryDigest",
    "KvInventoryPublisher",
    "KvPushRouter",
    "KvRouterConfig",
    "KvScheduler",
    "KvStats",
    "OverlapScores",
    "RadixTree",
    "RouterEvent",
    "WorkerMetricsPublisher",
    "WorkerStats",
    "make_kv_router_factory",
]
