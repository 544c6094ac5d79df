"""Layered runtime configuration (the fields of
``dynamo_tpu.runtime.config.RuntimeConfig`` that the port reads).

defaults <- TOML file (``DTPU_CONFIG_PATH``, read with ``tomllib``) <-
``DTPU_*`` environment variables, as in the reference. A setting of the
reference that the port does not have (the overload and SLO tables,
static mode, thread sizing) raises ``ValueError`` naming the ROADMAP item
it waits for, instead of being ignored. ``system_enabled`` and
``system_port`` start the system status server (``runtime/health.py``).
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any

ENV_PREFIX = "DTPU_"

# Settings of the reference's RuntimeConfig that the port lacks, and the
# ROADMAP item each waits for.
_NOT_PORTED = {
    "overload": "item 12a (overload admission and circuit breakers)",
    "slo": "item 12a (the SLO plane)",
    "static_mode": "item 12a (static mode without a coordinator)",
    "num_worker_threads": "item 12a (runtime thread sizing)",
}


def _env(name: str) -> str | None:
    return os.environ.get(ENV_PREFIX + name)


def _refuse(setting: str, field: str) -> None:
    raise ValueError(f"{setting} is not ported: the port's RuntimeConfig "
                     f"has no {field!r}; it waits for ROADMAP "
                     f"{_NOT_PORTED[field]}")


@dataclasses.dataclass
class RuntimeConfig:
    """Node-level runtime settings."""

    # Control plane (coordinator = etcd+NATS equivalent).
    coordinator_url: str = "tcp://127.0.0.1:4222"
    # Namespace default for this process.
    namespace: str = "dynamo"
    # Lease TTL for liveness.
    lease_ttl_s: float = 10.0
    # Request-plane bind host for worker endpoints (ephemeral port).
    bind_host: str = "127.0.0.1"
    advertise_host: str | None = None
    # Graceful-shutdown drain timeout.
    shutdown_timeout_s: float = 10.0
    # How long a deregistered instance's in-flight streams may keep
    # draining before the request-plane connection is force-closed.
    retire_drain_s: float = 30.0
    # Per-stream inter-frame deadline on the request plane: a stream with
    # no frames for this long fails typed (StreamIncompleteError ->
    # migration) instead of hanging on a zombie connection. 0 disables.
    stream_idle_timeout_s: float = 300.0
    # System status server (/health, /live, /metrics, /debug/*) per
    # process; port 0 picks a free one.
    system_enabled: bool = False
    system_port: int = 0

    @classmethod
    def from_settings(cls) -> "RuntimeConfig":
        """defaults <- TOML (DTPU_CONFIG_PATH) <- DTPU_* env."""
        cfg = cls()
        toml_path = _env("CONFIG_PATH")
        if toml_path and os.path.exists(toml_path):
            with open(toml_path, "rb") as fh:
                data: dict[str, Any] = tomllib.load(fh)
            for key in data:
                if key in _NOT_PORTED:
                    _refuse(f"{key!r} in {toml_path}", key)
            for field in dataclasses.fields(cls):
                if field.name in data:
                    setattr(cfg, field.name, data[field.name])
        for key in _NOT_PORTED:
            name = ENV_PREFIX + key.upper()
            if key in ("overload", "slo"):
                hits = sorted(k for k in os.environ
                              if k.startswith(name + "_"))
                if hits:
                    _refuse(hits[0], key)
            elif name in os.environ:
                _refuse(name, key)
        for field in dataclasses.fields(cls):
            raw = _env(field.name.upper())
            if raw is None:
                continue
            if field.type == "float":
                setattr(cfg, field.name, float(raw))
            elif field.type == "int":
                setattr(cfg, field.name, int(raw))
            elif field.type == "bool":
                setattr(cfg, field.name, raw.strip().lower()
                        in ("1", "true", "yes", "on"))
            else:
                setattr(cfg, field.name, raw)
        return cfg

    @property
    def coordinator_addr(self) -> tuple[str, int]:
        url = self.coordinator_url
        if "://" in url:
            url = url.split("://", 1)[1]
        host, _, port = url.rpartition(":")
        return host or "127.0.0.1", int(port)
