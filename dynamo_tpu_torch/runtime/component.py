"""Component addressing: Namespace -> Component -> Endpoint -> Instance
(copy of ``dynamo_tpu.runtime.component``).

Components are addressed ``{namespace}/{component}/{endpoint}``; live
instances register under the ``instances/`` key root on their lease, so
clients discover and watch them. The registration carries the framed-TCP
host and port that reach the instance.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.client import EndpointClient
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.service import EndpointServer

INSTANCE_ROOT = "instances/"


@dataclasses.dataclass(frozen=True)
class Instance:
    """A live endpoint instance."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int
    host: str
    port: int

    @property
    def path(self) -> str:
        return (f"{INSTANCE_ROOT}{self.namespace}/{self.component}/"
                f"{self.endpoint}/{self.instance_id:x}")

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, data: dict) -> "Instance":
        return cls(**{f.name: data[f.name] for f in dataclasses.fields(cls)})


def instance_prefix(namespace: str, component: str,
                    endpoint: str | None = None) -> str:
    base = f"{INSTANCE_ROOT}{namespace}/{component}/"
    return base if endpoint is None else f"{base}{endpoint}/"


class Namespace:
    def __init__(self, runtime: "DistributedRuntime", name: str):
        self._runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self._runtime, self.name, name)


class Component:
    def __init__(self, runtime: "DistributedRuntime", namespace: str,
                 name: str):
        self._runtime = runtime
        self.namespace = namespace
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.name}"

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self._runtime, self, name)


class Endpoint:
    def __init__(self, runtime: "DistributedRuntime", component: Component,
                 name: str):
        self._runtime = runtime
        self.component = component
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.component.path}/{self.name}"

    async def serve_endpoint(self, handler: Callable[..., Any],
                             graceful_shutdown: bool = True
                             ) -> "EndpointServer":
        """Serve ``handler`` (async generator fn (request, context) ->
        yields responses) as a discoverable instance. Returns the started
        EndpointServer (call ``.shutdown()``)."""
        from dynamo_tpu_torch.runtime.service import EndpointServer

        server = EndpointServer(self._runtime, self, handler,
                                graceful_shutdown=graceful_shutdown)
        await server.start()
        return server

    async def client(self, router_mode: str = "round_robin"
                     ) -> "EndpointClient":
        """A client that discovers this endpoint's instances and routes
        to them."""
        from dynamo_tpu_torch.runtime.client import EndpointClient

        client = EndpointClient(self._runtime, self, router_mode=router_mode)
        await client.start()
        return client
