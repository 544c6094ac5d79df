"""Disaggregated prefill and decode: the worker-side handlers and the
conditional-disaggregation config (counterpart of
``dynamo_tpu.llm.disagg``).

- The PREFILL worker serves a prefill-only endpoint
  (``make_prefill_handler``): it prefills the prompt on its engine thread,
  samples the first token and sends the prompt's KV, either as a ticket
  for its KV plane (``llm/kv_plane.py``; with a chunk-streamed extract the
  ticket goes out before the prefill ends) or inline as ``kv_chunk``
  frames (``llm/kv_transfer.py``), and then the first token. It registers
  no model: only decode workers discover it.
- The DECODE worker (``DisaggDecodeHandler``) forwards prompts longer than
  ``max_local_prefill_length`` to a prefill worker (round robin, or the
  shared queue of ``llm/prefill_queue.py``), inserts the parcel into its
  own pool and decodes from the first token
  (``GPUEngine.generate_injected``). Shorter prompts, adapter requests
  and every remote failure prefill locally; ``remote_failures`` counts
  the failures.

The threshold is dynamic: ``DisaggRouterConfig`` reads
``disagg/<model>`` from the coordinator and watches it. Tracing spans and
phase metrics wait for ROADMAP item 12.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from dynamo_tpu_torch.llm.kv_plane import KvPlaneClient
from dynamo_tpu_torch.llm.kv_transfer import (collect_prefill_response,
                                              kv_to_chunks)
from dynamo_tpu_torch.llm.model_card import model_slug
from dynamo_tpu_torch.llm.protocols import LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import (EngineError, NoInstancesError,
                                             StreamIncompleteError)
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.retry import Backoff, policies

log = get_logger("disagg")

DISAGG_CONFIG_ROOT = "disagg/"

# Default component prefill workers serve under (decode workers discover
# them by it).
PREFILL_COMPONENT = "prefill"
PREFILL_ENDPOINT = "generate"

# What a remote prefill may raise that a local prefill recovers from.
REMOTE_FAILURES = (NoInstancesError, StreamIncompleteError, EngineError,
                   ConnectionError, OSError, RuntimeError, ValueError)


def disagg_config_key(model_name: str) -> str:
    return f"{DISAGG_CONFIG_ROOT}{model_slug(model_name)}"


class DisaggRouterConfig:
    """Per-model conditional-disaggregation threshold, read from the
    coordinator and watched for updates."""

    def __init__(self, max_local_prefill_length: int = 512):
        self.max_local_prefill_length = max_local_prefill_length
        self._watch = None
        self._client = None
        self._key: str | None = None
        self._task: asyncio.Task | None = None
        self.watch_restarts = 0

    def prefill_remote(self, prompt_len: int) -> bool:
        return prompt_len > self.max_local_prefill_length

    @classmethod
    async def from_coordinator_with_watch(
            cls, client, model_name: str,
            default_max_local: int = 512) -> "DisaggRouterConfig":
        cfg = cls(default_max_local)
        cfg._client = client
        cfg._key = disagg_config_key(model_name)
        watch = await client.watch_prefix(cfg._key)
        cfg._apply_snapshot(watch)
        cfg._watch = watch
        cfg._task = asyncio.create_task(cfg._watch_loop())
        return cfg

    def _apply(self, value) -> None:
        if isinstance(value, dict) and "max_local_prefill_length" in value:
            self.max_local_prefill_length = int(
                value["max_local_prefill_length"])
            log.info("disagg config updated: max_local_prefill_length=%d",
                     self.max_local_prefill_length)

    def _apply_logged(self, value) -> None:
        try:
            self._apply(value)
        except (TypeError, ValueError):
            log.warning("malformed disagg config ignored: %r", value)

    def _apply_snapshot(self, watch) -> None:
        for item in watch.snapshot:
            self._apply_logged(item["v"])

    async def _watch_loop(self) -> None:
        """Apply config puts until cancelled. It never dies silently: a
        failed watch is re-established under ``policies.COORD_RECONNECT``,
        or the threshold would freeze at its last value."""
        backoff = Backoff(policies.COORD_RECONNECT)
        while True:
            try:
                async for event in self._watch:
                    if event["event"] == "put":
                        self._apply_logged(event["value"])
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — survive, re-watch
                log.exception("disagg config watch failed; re-watching")
            await backoff.sleep()
            try:
                self._watch = await self._client.watch_prefix(self._key)
                self._apply_snapshot(self._watch)
                self.watch_restarts += 1
                backoff.reset()
            except (ConnectionError, OSError, RuntimeError):
                log.warning("disagg config re-watch failed; will retry")

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
        if self._watch:
            await self._watch.cancel()


def make_prefill_handler(engine, plane=None):
    """The prefill worker's endpoint handler: prompt in, KV and first
    token out. With ``plane`` (a KvPlaneServer) the parcel is staged there
    and the stream carries its ticket; without it the stream carries one
    meta frame ``{shape, dtype, n_chunks, prompt_len}``, the ``kv_chunk``
    frames, then the first token."""

    async def handle(request, context: Context) -> AsyncIterator[dict]:
        if isinstance(request, dict) and request.get("clear_kv_blocks"):
            yield {"cleared": await engine.clear_kv_blocks()}
            return
        req = (request if isinstance(request, PreprocessedRequest)
               else PreprocessedRequest.from_wire(request))
        if plane is not None:
            # The engine stages the ticket BEFORE prefilling when it
            # streams the extract and hands it over through on_ticket:
            # yield it at once so the decode worker's pull overlaps the
            # remaining chunks.
            loop = asyncio.get_running_loop()
            ticket_fut: asyncio.Future = loop.create_future()

            def on_ticket(t: dict) -> None:
                loop.call_soon_threadsafe(
                    lambda: ticket_fut.done() or ticket_fut.set_result(t))

            job = asyncio.ensure_future(engine.run_job(
                lambda: engine.prefill_extract_staged(
                    req, plane, on_ticket=on_ticket)))
            await asyncio.wait({job, ticket_fut},
                               return_when=asyncio.FIRST_COMPLETED)
            streamed = ticket_fut.done() and not job.done()
            if streamed:
                yield LLMEngineOutput(disagg_params={
                    "ticket": ticket_fut.result()}).to_wire()
            first_token, ticket, prompt_len = await job
            log.info("prefill parcel staged%s: %d tokens, ticket %d",
                     " (chunk-streamed)" if streamed else "", prompt_len,
                     ticket["id"])
            if not streamed:
                yield LLMEngineOutput(
                    disagg_params={"ticket": ticket}).to_wire()
            yield LLMEngineOutput(token_ids=[first_token]).to_wire()
            return
        first_token, kv, prompt_len = await engine.run_job(
            lambda: engine.prefill_extract(req))
        meta, chunks = kv_to_chunks(kv)
        meta["prompt_len"] = prompt_len
        log.info("prefill parcel sent inline: %d tokens, %d chunks",
                 prompt_len, len(chunks))
        yield LLMEngineOutput(disagg_params=meta).to_wire()
        for chunk in chunks:
            if context.is_killed or context.is_stopped:
                return
            yield LLMEngineOutput(disagg_params={"kv_chunk": chunk}).to_wire()
        yield LLMEngineOutput(token_ids=[first_token]).to_wire()

    return handle


class DisaggDecodeHandler:
    """The decode worker's handler, with conditional remote prefill.
    ``prefill_client`` is an EndpointClient of the prefill workers'
    endpoint."""

    def __init__(self, engine, prefill_client, config: DisaggRouterConfig,
                 plane_client: KvPlaneClient | None = None,
                 queue_dispatcher=None):
        self.engine = engine
        self.prefill_client = prefill_client
        self.config = config
        self.plane_client = plane_client or KvPlaneClient()
        # Queue dispatch (llm/prefill_queue.py): when set, remote prefills
        # go through the shared coordinator queue instead of round robin.
        self.queue_dispatcher = queue_dispatcher
        self.remote_prefills = 0
        self.local_prefills = 0
        self.remote_failures = 0

    def handler(self):
        async def handle(request, context):
            if isinstance(request, dict) and request.get("clear_kv_blocks"):
                # This pool, and every prefill worker this decode worker
                # fronts (the frontend discovers only decode workers).
                freed = await self.engine.clear_kv_blocks()
                for iid in self.prefill_client.instance_ids():
                    try:
                        stream = await self.prefill_client.generate(
                            {"clear_kv_blocks": True}, instance_id=iid)
                        async for item in stream:
                            freed += item.get("cleared", 0)
                    except Exception:  # noqa: BLE001 — best-effort admin
                        log.warning("clear_kv_blocks failed on prefill %x",
                                    iid, exc_info=True)
                yield {"cleared": freed}
                return
            if isinstance(request, dict) and request.get("embed"):
                # Refused as the aggregated worker refuses it.
                async for out in self.engine.handler()(request, context):
                    yield out
                return
            async for out in self.generate(request, context):
                yield out
        return handle

    async def generate(self, request, context: Context) -> AsyncIterator[dict]:
        req = (request if isinstance(request, PreprocessedRequest)
               else PreprocessedRequest.from_wire(request))
        # Adapter requests stay local: prefill workers hold base weights.
        if self.config.prefill_remote(len(req.token_ids)) and not req.adapter:
            injected = await self._remote_prefill(req, context)
            if injected is not None:
                self.remote_prefills += 1
                first_token, kv = injected
                async for out in self.engine.generate_injected(
                        req, context, first_token, kv):
                    yield out
                return
        self.local_prefills += 1
        async for out in self.engine.generate(req, context):
            yield out

    async def _remote_prefill(self, req: PreprocessedRequest,
                              context: Context):
        """(first_token, parcel) from a prefill worker, or None to prefill
        locally: a remote failure degrades to aggregated serving and never
        fails the request."""
        try:
            if self.queue_dispatcher is not None:
                return await self.queue_dispatcher.remote_prefill(
                    req, context=context)
            stream = await self.prefill_client.generate(
                req.to_wire(), context=context, mode="round_robin")
            return await collect_prefill_response(
                stream, plane_client=self.plane_client)
        except REMOTE_FAILURES as exc:
            self.remote_failures += 1
            log.warning("remote prefill failed (%s: %s); prefilling locally",
                        type(exc).__name__, exc)
            return None
