"""Runtime error types (copy of part of ``dynamo_tpu.runtime.errors``) and
the request plane's error tokens.

An endpoint server ends a failed stream with an ``err`` frame whose ``e``
is one of: ``incomplete`` or ``incomplete:<reason>`` (the stream was cut
by a drain or the handler's ``GeneratorExit``; the client raises
``StreamIncompleteError``, which ``Migration`` retries), ``killed`` (the
client's own kill echoed back), ``invalid_request: <text>`` (the request
failed validation; the client raises ``InvalidRequestError``, HTTP 400),
``overloaded: <text>`` (no capacity; ``OverloadedError``, HTTP 503 with
``Retry-After``: every LoRA slot held, or the engine's SLA admission),
``rate_limited: <text>`` (client pacing: a deadline the admission
projection cannot meet, or batch traffic shed under brownout;
``RateLimitedError``, HTTP 429 with ``Retry-After``),
``role_transition: <text>`` (a role-flip directive the worker fenced out;
``RoleTransitionError``),
``adapter_not_found: <text>`` (the request named a LoRA adapter the worker
does not serve; ``AdapterNotFoundError``, HTTP 404), or the handler's
error as ``<ExceptionClass>: <text>`` (the client raises ``EngineError``).
The tokens are the JAX package's.
"""

INCOMPLETE = "incomplete"
KILLED = "killed"


class EngineError(RuntimeError):
    """Error raised by an engine/handler, propagated through response streams."""


class StreamIncompleteError(EngineError):
    """The response stream ended before generation completed (worker died or
    connection dropped mid-stream). The Migration operator retries on exactly
    this condition."""

    def __init__(self, message: str = "Stream ended before generation completed",
                 reason: str | None = None):
        super().__init__(message)
        #: Why the stream ended early, when the worker said so
        #: (``incomplete:<reason>``, which JAX workers send on a drain).
        self.reason = reason


class NoInstancesError(EngineError):
    """No live instances are registered for the target endpoint. The front
    answers 503."""


class OverloadedError(EngineError):
    """Capacity rejection: every worker busy (the KV router's
    ``busy_threshold``), the admission queue full, or the engine's
    projected-TTFT gate. The front answers 503 with ``Retry-After``; on
    the wire the class rides an ``overloaded: `` prefix."""

    WIRE_PREFIX = "overloaded: "
    retryable = True

    def __init__(self, message: str = "overloaded",
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RateLimitedError(EngineError):
    """Client-pacing rejection: the deadline is infeasible under the
    admission projection, it expired while queued, or batch traffic was
    shed under brownout. The front answers 429 with
    ``error.type="rate_limited"`` and ``Retry-After``; unlike
    ``OverloadedError`` it is not retryable as it is. On the wire the
    class rides a ``rate_limited: `` prefix."""

    WIRE_PREFIX = "rate_limited: "
    retryable = False

    def __init__(self, message: str = "rate limited",
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RoleTransitionError(EngineError):
    """A role-flip directive rejected by a worker's role state machine
    (stale epoch, unknown role, a flip already in flight). Not retryable
    as it is. On the wire the class rides a ``role_transition: ``
    prefix."""

    WIRE_PREFIX = "role_transition: "
    retryable = False


class InvalidRequestError(EngineError):
    """The request itself is invalid (engine-level validation: unsupported
    sampling features, over-length prompts). Maps to HTTP 400 at the
    front; workers mark it on the wire with an 'invalid_request: ' prefix
    so the class survives the request plane."""

    WIRE_PREFIX = "invalid_request: "


class AdapterNotFoundError(EngineError):
    """The request named a LoRA adapter this worker does not serve (an
    ``AdapterStore`` registry miss). The front answers 404: a naming
    error, not a capacity condition, and not retryable as it is. On the
    wire the class rides an ``adapter_not_found: `` prefix."""

    WIRE_PREFIX = "adapter_not_found: "


def error_from_wire(payload) -> EngineError:
    """The exception a client raises for an ``err`` frame's payload."""
    if isinstance(payload, str):
        if payload == INCOMPLETE or payload.startswith(INCOMPLETE + ":"):
            _, _, why = payload.partition(":")
            return StreamIncompleteError(reason=why or None)
        if payload.startswith(InvalidRequestError.WIRE_PREFIX):
            return InvalidRequestError(
                payload[len(InvalidRequestError.WIRE_PREFIX):])
        if payload.startswith(RateLimitedError.WIRE_PREFIX):
            return RateLimitedError(
                payload[len(RateLimitedError.WIRE_PREFIX):])
        if payload.startswith(RoleTransitionError.WIRE_PREFIX):
            return RoleTransitionError(
                payload[len(RoleTransitionError.WIRE_PREFIX):])
        if payload.startswith(OverloadedError.WIRE_PREFIX):
            return OverloadedError(payload[len(OverloadedError.WIRE_PREFIX):])
        if payload.startswith(AdapterNotFoundError.WIRE_PREFIX):
            return AdapterNotFoundError(
                payload[len(AdapterNotFoundError.WIRE_PREFIX):])
    return EngineError(payload)
