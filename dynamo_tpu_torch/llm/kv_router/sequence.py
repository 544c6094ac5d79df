"""Optimistic in-flight accounting per worker (copy of
``dynamo_tpu.llm.kv_router.sequence``).

Between worker metric updates the router tracks, per worker, the blocks
and decode sequences it has dispatched itself, so consecutive routing
decisions see each other's load at once. Replica routers exchange the
same add/free/mark events (the router_sync subject).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class _WorkerLoad:
    active_blocks: int = 0
    active_seqs: int = 0
    prefill_tokens: int = 0
    # request_id -> (blocks, prefill_tokens)
    requests: dict[str, tuple[int, int]] = dataclasses.field(
        default_factory=dict)


class ActiveSequencesMultiWorker:
    def __init__(self):
        self._workers: dict[int, _WorkerLoad] = {}

    def ensure_worker(self, worker_id: int) -> _WorkerLoad:
        return self._workers.setdefault(worker_id, _WorkerLoad())

    def remove_worker(self, worker_id: int) -> None:
        self._workers.pop(worker_id, None)

    def add_request(self, worker_id: int, request_id: str, new_blocks: int,
                    prefill_tokens: int) -> None:
        load = self.ensure_worker(worker_id)
        load.requests[request_id] = (new_blocks, prefill_tokens)
        load.active_blocks += new_blocks
        load.active_seqs += 1
        load.prefill_tokens += prefill_tokens

    def mark_prefill_complete(self, worker_id: int, request_id: str) -> None:
        load = self._workers.get(worker_id)
        if load is None:
            return
        entry = load.requests.get(request_id)
        if entry is None:
            return
        blocks, prefill = entry
        load.requests[request_id] = (blocks, 0)
        load.prefill_tokens -= prefill

    def free(self, worker_id: int, request_id: str) -> None:
        load = self._workers.get(worker_id)
        if load is None:
            return
        entry = load.requests.pop(request_id, None)
        if entry is None:
            return
        blocks, prefill = entry
        load.active_blocks -= blocks
        load.active_seqs -= 1
        load.prefill_tokens -= prefill

    def active_blocks(self, worker_id: int) -> int:
        load = self._workers.get(worker_id)
        return load.active_blocks if load else 0

    def active_seqs(self, worker_id: int) -> int:
        load = self._workers.get(worker_id)
        return load.active_seqs if load else 0

    def prefill_tokens(self, worker_id: int) -> int:
        load = self._workers.get(worker_id)
        return load.prefill_tokens if load else 0
