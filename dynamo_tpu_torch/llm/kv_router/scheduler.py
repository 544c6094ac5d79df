"""Worker selection: overlap-aware cost with softmax temperature sampling
(copy of ``dynamo_tpu.llm.kv_router.scheduler``). For each candidate:

  potential_prefill_blocks = request_blocks - overlap_blocks(worker)
  potential_active_blocks  = predicted_active_blocks(worker) + request_blocks
  pending_prefill_blocks   = ledger prefill tokens(worker) / block_size
  logit = overlap_score_weight * potential_prefill_blocks
          + potential_active_blocks + pending_prefill_blocks

lower is better. With temperature 0 the argmin wins (ties go to the first
candidate); with temperature > 0 a worker is sampled from
softmax(-logit / T). ``busy_threshold`` raises ``OverloadedError`` when
every worker's KV usage is at or above it. The circuit-breaker board that
the reference consults first (``health``) waits for ROADMAP item 12a and
stays None.
"""

from __future__ import annotations

import dataclasses
import math
import random

from dynamo_tpu_torch.llm.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequencesMultiWorker
from dynamo_tpu_torch.runtime.errors import OverloadedError


@dataclasses.dataclass
class KvRouterConfig:
    overlap_score_weight: float = 1.0
    temperature: float = 0.0
    busy_threshold: float | None = None  # fraction of KV blocks in use
    block_size: int = 16
    # Federated routing: score each candidate by the larger of its radix
    # overlap and its inventory-sketch overlap. False = radix only.
    federation: bool = True


class KvScheduler:
    def __init__(self, config: KvRouterConfig,
                 sequences: ActiveSequencesMultiWorker):
        self.config = config
        self.sequences = sequences
        # Latest ForwardPassMetrics per worker.
        self.metrics: dict[int, ForwardPassMetrics] = {}
        # Per-worker circuit breakers: ROADMAP item 12a.
        self.health = None

    def update_metrics(self, metrics: ForwardPassMetrics) -> None:
        self.metrics[metrics.worker_id] = metrics

    def remove_worker(self, worker_id: int) -> None:
        self.metrics.pop(worker_id, None)
        self.sequences.remove_worker(worker_id)

    def _predicted_blocks(self, worker_id: int) -> int:
        """The larger of the worker's published active blocks and this
        router's ledger: metrics lag by the publish interval, the ledger
        by completion, and summing them would count a request twice."""
        m = self.metrics.get(worker_id)
        observed = m.kv_stats.kv_active_blocks if m else 0
        return max(observed, self.sequences.active_blocks(worker_id))

    def _usage(self, worker_id: int) -> float:
        m = self.metrics.get(worker_id)
        if m is None or m.kv_stats.kv_total_blocks == 0:
            return 0.0
        return min(1.0, self._predicted_blocks(worker_id)
                   / m.kv_stats.kv_total_blocks)

    def select(self, workers: list[int], request_blocks: int,
               overlaps: OverlapScores) -> tuple[int, int]:
        """Pick a worker; returns (worker_id, overlap_blocks). Raises
        OverloadedError (503 + Retry-After at the front) when there is no
        candidate or, with busy_threshold set, every one is above it."""
        if not workers:
            raise OverloadedError("no candidate workers")
        if self.config.busy_threshold is not None:
            free = [w for w in workers
                    if self._usage(w) < self.config.busy_threshold]
            if not free:
                raise OverloadedError(
                    f"all {len(workers)} workers above busy threshold "
                    f"{self.config.busy_threshold}")
            workers = free
        logits: list[float] = []
        for w in workers:
            overlap = overlaps.get(w, 0)
            potential_prefill = max(0, request_blocks - overlap)
            potential_active = self._predicted_blocks(w) + request_blocks
            # Outstanding prefill work apart from decode residency: a
            # worker still chewing through big prompts is a bad target
            # even when its resident blocks look fine.
            pending_prefill = (self.sequences.prefill_tokens(w)
                               / max(1, self.config.block_size))
            logits.append(self.config.overlap_score_weight * potential_prefill
                          + potential_active + pending_prefill)
        if self.config.temperature <= 0.0:
            best = min(range(len(workers)), key=lambda i: logits[i])
        else:
            t = self.config.temperature
            mx = max(-l / t for l in logits)
            weights = [math.exp(-l / t - mx) for l in logits]
            best = random.choices(range(len(workers)), weights=weights, k=1)[0]
        chosen = workers[best]
        return chosen, overlaps.get(chosen, 0)
