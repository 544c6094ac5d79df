"""Request context: identity, cancellation, tracing ids (copy of
``dynamo_tpu.runtime.context.Context`` without the wire helpers).

Every request carries a stable id, a two-level cancellation signal (stop =
graceful stop issuing a final response; kill = hard abort) and trace ids.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any

from dynamo_tpu_torch.runtime.logging import (generate_span_id,
                                              generate_trace_id)


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
