"""Model discovery: watcher, manager and routed pipeline assembly (copy of
``dynamo_tpu.llm.discovery`` without the storage plug-in, fleet hooks,
journal events and spans).

``ModelWatcher`` watches the coordinator's ``models/`` prefix. On the first
instance of a model it fetches the tokenizer from the object store and
assembles Preprocessor -> Backend (detokenize) -> Migration -> router:
a RouterEngine (endpoint client, round robin or random) or, under
``router_mode="kv"``, the KV router that ``kv_router_factory`` builds
(``make_kv_router_factory()`` at its defaults when none is given),
shared by every model name served by the same worker endpoint. On
lease-expiry deletes it tells the KV router at once that the worker left
(``note_worker_leave``) and drops the model when its last instance is
gone. The one-process launcher fills a ``ModelManager`` with a local
``ServedModel`` instead.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.kv_router.router import make_kv_router_factory
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.model_card import (MODEL_ROOT, ModelEntry,
                                             fetch_tokenizer, model_slug)
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("discovery")


ROUTER_MODES = ("round_robin", "random", "kv")


def check_router_mode(mode: str) -> None:
    """Raise ``ValueError`` for a router mode the port does not serve."""
    if mode not in ROUTER_MODES:
        raise ValueError(f"router mode must be one of "
                         f"{', '.join(ROUTER_MODES)}, got {mode!r}")


class RouterEngine(AsyncEngine):
    """Pipeline sink: pushes the preprocessed request to a worker instance
    through the request plane."""

    def __init__(self, client, router_mode: str = "round_robin"):
        self.client = client
        self.router_mode = router_mode

    async def generate(self, request, context: Context) -> AsyncIterator[dict]:
        stream = await self.client.generate(
            request if isinstance(request, dict) else request.to_wire(),
            context=context, mode=self.router_mode)
        async for item in stream:
            yield item


class ServedModel:
    """One servable model: its entry, its tokenizer-bound pipeline and, when
    it is routed to workers, its endpoint client."""

    def __init__(self, entry: ModelEntry, preprocessor: OpenAIPreprocessor,
                 client=None, router=None):
        self.entry = entry
        self.preprocessor = preprocessor
        self.client = client
        self.router = router
        self.instances: set[int] = set()

    @property
    def name(self) -> str:
        return self.entry.model_name


class ModelManager:
    """Holds the set of currently-servable models."""

    def __init__(self):
        self.models: dict[str, ServedModel] = {}

    def get(self, name: str) -> ServedModel | None:
        return self.models.get(name)

    def list_models(self) -> list[dict]:
        return [{"id": m.name, "object": "model", "created": 0,
                 "owned_by": "dynamo-tpu"} for m in self.models.values()]


class ModelWatcher:
    def __init__(self, runtime, manager: ModelManager,
                 router_mode: str = "round_robin", kv_router_factory=None):
        check_router_mode(router_mode)
        self._runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        if router_mode == "kv" and kv_router_factory is None:
            kv_router_factory = make_kv_router_factory()
        self._kv_router_factory = kv_router_factory
        # KV routers shared by the model names served at the SAME worker
        # endpoint, so one radix and fleet view covers them; keyed by
        # (namespace, component, endpoint), with the names using each, so
        # the last one out closes it.
        self._router_share: dict[tuple, dict] = {}
        self._task: asyncio.Task | None = None
        self._watch = None
        self._lock = asyncio.Lock()

    async def start(self) -> None:
        self._watch = await self._runtime.require_coordinator().watch_prefix(
            MODEL_ROOT)
        for item in self._watch.snapshot:
            await self._on_put(item["k"], item["v"])
        self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        async for event in self._watch:
            try:
                if event["event"] == "put":
                    await self._on_put(event["key"], event["value"])
                else:
                    await self._on_delete(event["key"])
            except Exception:  # noqa: BLE001 — keep watching
                log.exception("model watch event failed")

    async def _on_put(self, key: str, value: dict) -> None:
        entry = ModelEntry.from_wire(value)
        instance_hex = key.rsplit("/", 1)[-1]
        async with self._lock:
            served = self.manager.models.get(entry.model_name)
            if served is None:
                served = await self._build(entry)
                self.manager.models[entry.model_name] = served
                log.info("model %s now served via %s/%s/%s",
                         entry.model_name, entry.namespace, entry.component,
                         entry.endpoint)
            try:
                served.instances.add(int(instance_hex, 16))
            except ValueError:
                return

    async def _on_delete(self, key: str) -> None:
        parts = key[len(MODEL_ROOT):].split("/")
        if len(parts) != 2:
            return
        slug, instance_hex = parts
        try:
            iid = int(instance_hex, 16)
        except ValueError:
            iid = None
        async with self._lock:
            for name, served in list(self.manager.models.items()):
                if model_slug(name) != slug:
                    continue
                if iid is not None and iid in served.instances:
                    served.instances.discard(iid)
                    # Membership beats staleness: the KV router drops the
                    # worker's index and inventory now, so a gone worker
                    # attracts no more requests.
                    note_leave = getattr(served.router, "note_worker_leave",
                                         None)
                    if note_leave is not None:
                        note_leave(iid)
                if not served.instances:
                    log.info("model %s: last instance gone; removing", name)
                    await self._close_served(served)
                    del self.manager.models[name]

    async def _close_served(self, served: ServedModel) -> None:
        for key, share in list(self._router_share.items()):
            if share["router"] is served.router:
                share["users"].discard(served.name)
                if share["users"]:
                    return  # other served names still use it
                del self._router_share[key]
                break
        router_close = getattr(served.router, "close", None)
        if router_close is not None:
            await router_close()  # also closes the endpoint client
        elif served.client is not None:
            await served.client.close()

    async def _build(self, entry: ModelEntry) -> ServedModel:
        coordinator = self._runtime.require_coordinator()
        tokenizer = await fetch_tokenizer(coordinator, entry.card)
        endpoint = (self._runtime.namespace(entry.namespace)
                    .component(entry.component).endpoint(entry.endpoint))
        if self.router_mode == "kv":
            share_key = (entry.namespace, entry.component, entry.endpoint)
            share = self._router_share.get(share_key)
            if share is None:
                client = await endpoint.client()
                router = await self._kv_router_factory(self._runtime, entry,
                                                       client)
                share = {"router": router, "client": client, "users": set()}
                self._router_share[share_key] = share
            client, router = share["client"], share["router"]
            share["users"].add(entry.model_name)
        else:
            client = await endpoint.client()
            router = RouterEngine(client, self.router_mode)
        chain = Migration(entry.card.migration_limit, inner=router)
        backend = Backend(tokenizer, inner=chain)
        preprocessor = OpenAIPreprocessor(entry.card, tokenizer, inner=backend)
        return ServedModel(entry, preprocessor, client, router)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        if self._watch:
            await self._watch.cancel()
        for served in list(self.manager.models.values()):
            await self._close_served(served)
        self.manager.models.clear()
