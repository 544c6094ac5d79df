"""DistributedRuntime: the node-level singleton (copy of
``dynamo_tpu.runtime.distributed.DistributedRuntime``).

It owns the coordinator client and the root of the process's metrics
registry (``metrics``, served at ``/metrics``); the instance id of
everything the process serves is its primary lease id.
``with_embedded_coordinator`` starts an in-process coordinator first, for
single-process deployments and tests; ``detached`` is the static mode,
with no control plane (``has_discovery`` False, a random instance id).
"""

from __future__ import annotations

import asyncio
import random

from dynamo_tpu_torch.runtime.component import Namespace
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.coordinator import Coordinator
from dynamo_tpu_torch.runtime.coordinator_client import CoordinatorClient
from dynamo_tpu_torch.runtime.logging import init_logging
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry


class DistributedRuntime:
    def __init__(self, config: RuntimeConfig,
                 coordinator_client: CoordinatorClient | None = None):
        self.config = config
        self.coordinator_client: CoordinatorClient | None = coordinator_client
        self._embedded_coordinator: Coordinator | None = None
        self.shutdown_event = asyncio.Event()
        # Root of the metrics hierarchy (runtime -> namespace -> component
        # -> endpoint).
        self.metrics = MetricsRegistry()
        # Instance ids are the primary lease id, as the etcd lease id
        # identifies an instance in the reference's design (a detached
        # runtime draws one).
        self.instance_id: int = (coordinator_client.primary_lease_id
                                 if coordinator_client is not None
                                 else random.getrandbits(63))
        # Model-card keys this process still serves: lease-recreated
        # replays re-put only these (llm/model_card.py).
        self.model_cards: set[str] = set()

    @classmethod
    async def from_settings(cls, config: RuntimeConfig | None = None
                            ) -> "DistributedRuntime":
        """Connect to the coordinator at ``config.coordinator_url``; raises
        ``ConnectionError`` when it cannot be reached."""
        init_logging()
        config = config or RuntimeConfig.from_settings()
        host, port = config.coordinator_addr
        client = await CoordinatorClient.connect(
            host, port, lease_ttl_s=config.lease_ttl_s)
        return cls(config, client)

    @classmethod
    async def detached(cls, config: RuntimeConfig | None = None
                       ) -> "DistributedRuntime":
        """Static mode: no control plane (the reference's
        ``from_settings_without_discovery``)."""
        init_logging()
        config = config or RuntimeConfig.from_settings()
        config.static_mode = True
        return cls(config)

    @property
    def has_discovery(self) -> bool:
        return self.coordinator_client is not None

    @classmethod
    async def with_embedded_coordinator(
            cls, config: RuntimeConfig | None = None) -> "DistributedRuntime":
        """Start an in-process coordinator on 127.0.0.1 (a free port), then
        connect to it; ``close`` stops it."""
        init_logging()
        config = config or RuntimeConfig.from_settings()
        coord = Coordinator("127.0.0.1", 0)
        await coord.start()
        config.coordinator_url = coord.url
        try:
            runtime = await cls.from_settings(config)
        except BaseException:
            await coord.stop()
            raise
        runtime._embedded_coordinator = coord
        return runtime

    def namespace(self, name: str | None = None) -> Namespace:
        return Namespace(self, name or self.config.namespace)

    def require_coordinator(self) -> CoordinatorClient:
        if self.coordinator_client is None:
            raise RuntimeError("runtime is closed (no control plane)")
        return self.coordinator_client

    def shutdown(self) -> None:
        self.shutdown_event.set()

    async def wait_for_shutdown(self) -> None:
        # Workers block here until a signal handler or a caller sets it.
        await self.shutdown_event.wait()

    async def close(self) -> None:
        self.shutdown()
        if self.coordinator_client is not None:
            await self.coordinator_client.close()
            self.coordinator_client = None
        if self._embedded_coordinator is not None:
            await self._embedded_coordinator.stop()
            self._embedded_coordinator = None

    @property
    def advertise_host(self) -> str:
        return self.config.advertise_host or self.config.bind_host
