"""Request-migration operator (copy of ``dynamo_tpu.llm.migration`` without
its metrics counter, journal event and span).

When a worker dies mid-stream (``StreamIncompleteError`` from the request
plane), re-issue the request to another instance with the tokens already
generated appended to the prompt and the token budget shrunk by them, up
to ``migration_limit`` times. With a limit of 0 the stream passes through
and the error reaches the caller. Retries pace themselves through
``policies.MIGRATION`` with a retry budget shared by every stream the
operator serves.
"""

from __future__ import annotations

import copy
from typing import AsyncIterator

from dynamo_tpu_torch.llm.protocols import (LLMEngineOutput,
                                            PreprocessedRequest)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Operator
from dynamo_tpu_torch.runtime.errors import StreamIncompleteError
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.retry import Backoff, RetryBudget, policies

log = get_logger("migration")


class Migration(Operator):
    def __init__(self, migration_limit: int = 0,
                 inner: AsyncEngine | None = None):
        super().__init__(inner)
        self.migration_limit = migration_limit
        # Shared across every stream this operator serves: a mass
        # disconnect drains the bucket and later migrations back off at the
        # policy max.
        self._budget = RetryBudget(rate=20.0, burst=50.0)

    async def generate(self, request: PreprocessedRequest | dict,
                       context: Context) -> AsyncIterator[LLMEngineOutput]:
        assert self.inner is not None
        original = (request if isinstance(request, PreprocessedRequest)
                    else PreprocessedRequest.from_wire(request))
        retries_left = self.migration_limit
        accumulated: list[int] = []
        req = original
        attempt = 0
        backoff = Backoff(policies.MIGRATION, budget=self._budget)
        while True:
            try:
                async for raw in self.inner.generate(req.to_wire(), context):
                    out = (raw if isinstance(raw, LLMEngineOutput)
                           else LLMEngineOutput.from_wire(raw))
                    accumulated.extend(out.token_ids)
                    yield out
                return
            except StreamIncompleteError as exc:
                budget = original.stop_conditions.max_tokens
                if budget is not None and len(accumulated) >= budget:
                    # The stream died on the final boundary: everything the
                    # caller asked for was delivered; a retry would
                    # overshoot the budget.
                    return
                if retries_left <= 0 or context.is_stopped:
                    raise
                retries_left -= 1
                attempt += 1
                context.values["migrations"] = attempt
                if exc.reason or "migration_reason" not in context.values:
                    context.values["migration_reason"] = (exc.reason
                                                          or "disconnect")
                log.warning(
                    "Stream disconnected (%s)... recreating stream "
                    "(%d retries left, carrying %d generated tokens)",
                    exc, retries_left, len(accumulated))
                await backoff.sleep()
                # Continue on another worker: the ORIGINAL prompt plus
                # everything generated so far is the new prompt, and the
                # budget shrinks by what was emitted. Rebuilding from
                # `original` keeps repeated migrations from double-counting.
                new_req = copy.deepcopy(original)
                new_req.token_ids = original.token_ids + accumulated
                if new_req.stop_conditions.max_tokens is not None:
                    new_req.stop_conditions.max_tokens = max(
                        1, new_req.stop_conditions.max_tokens
                        - len(accumulated))
                req = new_req
