"""Request context: identity, cancellation, tracing ids (copy of
``dynamo_tpu.runtime.context.Context``).

Every request carries a stable id, a two-level cancellation signal (stop =
graceful stop issuing a final response; kill = hard abort) and trace ids.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any

from dynamo_tpu_torch.runtime.logging import (generate_span_id,
                                              generate_trace_id,
                                              make_traceparent,
                                              parse_traceparent)


class Context:
    def __init__(self, request_id: str | None = None,
                 trace_id: str | None = None, parent_span_id: str | None = None):
        self.id: str = request_id or uuid.uuid4().hex
        self.trace_id: str = trace_id or generate_trace_id()
        self.span_id: str = generate_span_id()
        self.parent_span_id = parent_span_id
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        # Arbitrary cross-operator annotations.
        self.values: dict[str, Any] = {}

    def stop_generating(self) -> None:
        """Ask the engine to finish up: emit its final response then end
        the stream."""
        self._stopped.set()

    def kill(self) -> None:
        """Hard-abort: no further responses should be produced."""
        self._stopped.set()
        self._killed.set()

    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    @property
    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def wait_stopped(self) -> None:
        # Cancellation watcher by design: callers hold this as a task and
        # cancel it when the stream ends.
        await self._stopped.wait()

    def to_wire(self) -> dict:
        # The W3C traceparent rides every inter-component frame beside the
        # explicit ids, so a frontend's trace id reaches the worker.
        return {"id": self.id, "trace_id": self.trace_id,
                "span_id": self.span_id,
                "traceparent": make_traceparent(self.trace_id, self.span_id)}

    @classmethod
    def from_wire(cls, data: dict | None) -> "Context":
        data = data or {}
        trace_id, parent_id = data.get("trace_id"), data.get("span_id")
        if trace_id is None and data.get("traceparent"):
            # Frames from peers that only speak W3C: parse the header.
            parsed = parse_traceparent(data["traceparent"])
            if parsed:
                trace_id, parent_id = parsed["trace_id"], parsed["parent_id"]
        return cls(data.get("id"), trace_id, parent_id)
