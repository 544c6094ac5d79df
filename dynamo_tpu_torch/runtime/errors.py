"""Runtime error types the HTTP front catches (copy of part of
``dynamo_tpu.runtime.errors``)."""


class EngineError(RuntimeError):
    """Error raised by an engine/handler, propagated through response streams."""


class InvalidRequestError(EngineError):
    """The request itself is invalid (engine-level validation: unsupported
    sampling features, over-length prompts). Maps to HTTP 400 at the
    front."""
