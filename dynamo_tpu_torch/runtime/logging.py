"""Logging (copy of ``dynamo_tpu.runtime.logging``'s text path and its W3C
trace-context helpers).

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


def _is_lower_hex(s: str) -> bool:
    return bool(s) and all(c in "0123456789abcdef" for c in s)


def parse_traceparent(header: str) -> dict | None:
    """Parse a W3C ``traceparent`` header.

    Per the W3C trace-context spec, ids are lowercase hex, the all-zero
    trace-id/parent-id are invalid, and version ``ff`` is forbidden;
    malformed headers return None (the caller starts a fresh trace)."""
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, parent_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(parent_id) != 16 \
            or len(flags) != 2:
        return None
    if not all(_is_lower_hex(p) for p in (version, trace_id, parent_id,
                                          flags)):
        return None
    if version == "ff":
        return None
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return {"trace_id": trace_id, "parent_id": parent_id, "flags": flags,
            "version": version}


def make_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


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
