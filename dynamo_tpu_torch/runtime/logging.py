"""Logging (copy of ``dynamo_tpu.runtime.logging``'s text path).

DTPU_LOG sets the level filter, as in the reference; loggers live under
the ``dynamo_tpu_torch`` namespace.
"""

from __future__ import annotations

import logging
import os
import secrets
import sys
import time

_configured = False


def generate_trace_id() -> str:
    """128-bit lowercase hex trace id (W3C trace-context)."""
    return secrets.token_hex(16)


def generate_span_id() -> str:
    """64-bit lowercase hex span id."""
    return secrets.token_hex(8)


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        return (f"{ts}.{int(record.msecs):03d} {record.levelname:<5} "
                f"{record.name}: {record.getMessage()}"
                + (f"\n{self.formatException(record.exc_info)}"
                   if record.exc_info else ""))


def init_logging(level: str | None = None) -> None:
    """Idempotent logging init."""
    global _configured
    if _configured:
        return
    _configured = True
    level = level or os.environ.get("DTPU_LOG", "info")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_TextFormatter())
    root = logging.getLogger("dynamo_tpu_torch")
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    init_logging()
    return logging.getLogger(f"dynamo_tpu_torch.{name}")
