"""Core streaming-engine trait (copy of ``dynamo_tpu.runtime.engine``).

An engine maps one request to a stream of responses; every stream is
associated with a Context granting id/stop/kill.
"""

from __future__ import annotations

import abc
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime.context import Context


class AsyncEngine(abc.ABC):
    """SingleIn -> ManyOut streaming engine."""

    @abc.abstractmethod
    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        """Return an async iterator of responses for ``request``.

        Implementations are async generators; cancellation is cooperative via
        ``context.is_stopped`` / generator close.
        """
        raise NotImplementedError


class Operator(AsyncEngine):
    """An engine stage wrapping a downstream engine: the forward edge
    transforms the request, the backward edge the response stream."""

    def __init__(self, inner: AsyncEngine | None = None):
        self.inner = inner
