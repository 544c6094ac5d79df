"""Layered runtime configuration (copy of
``dynamo_tpu.runtime.config.RuntimeConfig``).

defaults <- TOML file (``DTPU_CONFIG_PATH``, read with ``tomllib``) <-
``DTPU_*`` environment variables, as in the reference. The overload
defense (``runtime/overload.py``) and the SLO plane (``runtime/slo.py``)
are nested settings: an ``[overload]`` / ``[slo]`` TOML table, then
``DTPU_OVERLOAD_<FIELD>`` / ``DTPU_SLO_<FIELD>`` per field
(``_apply_scalar_env``, which the canary's ``DTPU_CANARY_<FIELD>`` uses
too). ``system_enabled`` and ``system_port`` start the system status
server (``runtime/health.py``).
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any

from dynamo_tpu_torch.runtime.overload import OverloadConfig
from dynamo_tpu_torch.runtime.slo import SloConfig

ENV_PREFIX = "DTPU_"

# The nested settings and their classes.
_NESTED = {"overload": OverloadConfig, "slo": SloConfig}


def _env(name: str) -> str | None:
    return os.environ.get(ENV_PREFIX + name)


def _apply_scalar_env(prefix: str, obj: Any) -> None:
    """``DTPU_<PREFIX>_<FIELD>`` overrides of an all-scalar settings
    dataclass (``OverloadConfig``, ``SloConfig``, ``CanaryConfig``), typed
    by each field's current value, as the reference maps them."""
    for field in dataclasses.fields(type(obj)):
        raw = _env(f"{prefix}_" + field.name.upper())
        if raw is None:
            continue
        current = getattr(obj, field.name)
        if isinstance(current, bool):
            value: Any = raw.strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(current, int):
            value = int(raw)
        elif isinstance(current, float):
            value = float(raw)
        else:
            value = raw
        setattr(obj, field.name, value)


@dataclasses.dataclass
class RuntimeConfig:
    """Node-level runtime settings."""

    # Control plane (coordinator = etcd+NATS equivalent).
    coordinator_url: str = "tcp://127.0.0.1:4222"
    # Static mode: no discovery; endpoints are addressed directly
    # (``DistributedRuntime.detached``).
    static_mode: bool = False
    # Namespace default for this process.
    namespace: str = "dynamo"
    # Lease TTL for liveness.
    lease_ttl_s: float = 10.0
    # Request-plane bind host for worker endpoints (ephemeral port).
    bind_host: str = "127.0.0.1"
    advertise_host: str | None = None
    # Thread-pool sizing (the reference's worker threads).
    num_worker_threads: int = 4
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
    # Overload defense (runtime/overload.py): adaptive admission,
    # deadline-aware shedding, per-worker circuit breakers, brownout.
    overload: OverloadConfig = dataclasses.field(
        default_factory=OverloadConfig)
    # SLO plane (runtime/slo.py): targets, windowed SLIs, burn-rate
    # alerts, per-request accounting.
    slo: SloConfig = dataclasses.field(default_factory=SloConfig)

    @classmethod
    def from_settings(cls) -> "RuntimeConfig":
        """defaults <- TOML (DTPU_CONFIG_PATH) <- DTPU_* env."""
        cfg = cls()
        toml_path = _env("CONFIG_PATH")
        if toml_path and os.path.exists(toml_path):
            with open(toml_path, "rb") as fh:
                data: dict[str, Any] = tomllib.load(fh)
            for field in dataclasses.fields(cls):
                if field.name in data:
                    value = data[field.name]
                    if field.name in _NESTED and isinstance(value, dict):
                        value = _NESTED[field.name](**value)
                    setattr(cfg, field.name, value)
        for field in dataclasses.fields(cls):
            if field.name in _NESTED:
                _apply_scalar_env(field.name.upper(),
                                  getattr(cfg, field.name))
                continue
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
