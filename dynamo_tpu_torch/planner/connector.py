"""Scaling connectors (copy of ``dynamo_tpu.planner.connector``): how the
planner's replica decisions become replica changes. ``Connector`` is the
interface a substrate implements (``planner/kube.py``);
``FakeConnector`` records the decisions, for tests and dry runs.
"""

from __future__ import annotations

import abc

from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.connector")


class Connector(abc.ABC):
    @abc.abstractmethod
    async def scale(self, component: str, replicas: int) -> None:
        """Set the desired replica count for a worker component."""

    async def current(self, component: str) -> int | None:
        """Observed replica count, if the substrate can report it."""
        return None


class FakeConnector(Connector):
    """Records scale calls; optionally tracks a simulated replica count."""

    def __init__(self, initial: dict[str, int] | None = None):
        self.replicas: dict[str, int] = dict(initial or {})
        self.calls: list[tuple[str, int]] = []

    async def scale(self, component: str, replicas: int) -> None:
        self.calls.append((component, replicas))
        self.replicas[component] = replicas
        log.info("scale %s -> %d", component, replicas)

    async def current(self, component: str) -> int | None:
        return self.replicas.get(component)
