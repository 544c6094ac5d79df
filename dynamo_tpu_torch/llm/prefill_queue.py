"""Queue-based prefill dispatch (counterpart of
``dynamo_tpu.llm.prefill_queue``).

Instead of round-robining prompts at prefill workers, a decode worker
pushes ``{req, reply}`` onto the coordinator queue ``prefillq/<model>``
and awaits the reply subject; prefill workers pop when free, prefill and
stage the parcel on their KV plane, and publish ``{first_token, ticket}``
(or ``{error}``). A busy worker simply does not pop, so load levels across
the prefill pool. Queue DEPTH is the backpressure signal: at
``max_queue_depth`` or more the decode worker prefills locally instead of
enqueueing, and so it does when the reply does not come in time. The
items, subjects and replies are the JAX package's, so either package's
workers share one queue.
"""

from __future__ import annotations

import asyncio
import time
import uuid

from dynamo_tpu_torch.llm.model_card import model_slug
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.retry import Backoff, policies

log = get_logger("prefill_queue")

REPLY_PREFIX = "prefillr."


def queue_name(model_name: str) -> str:
    return f"prefillq/{model_slug(model_name)}"


class QueuePrefillWorker:
    """Prefill-worker side: pop -> prefill and stage -> reply, one at a
    time."""

    def __init__(self, engine, client, model_name: str, plane,
                 poll_timeout: float = 1.0):
        self.engine = engine
        self.client = client
        self.queue = queue_name(model_name)
        self.plane = plane
        self.poll_timeout = poll_timeout
        self.pulled = 0
        self.failed = 0
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                # Our own cancel; if stop() itself was cancelled, the
                # next await re-raises.
                pass
            except Exception:  # noqa: BLE001 — already torn down
                pass

    async def _loop(self) -> None:
        backoff = Backoff(policies.QUEUE_POP)
        while True:
            try:
                item = await self.client.queue_pop(
                    self.queue, timeout=self.poll_timeout)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the pull loop must survive
                log.exception("prefill queue pop failed; retrying")
                await backoff.sleep()
                continue
            backoff.reset()
            if item is not None:
                await self._serve_one(item)

    async def _serve_one(self, item: dict) -> None:
        reply = item.get("reply")
        try:
            req = PreprocessedRequest.from_wire(item["req"])
            first_token, ticket, prompt_len = await self.engine.run_job(
                lambda: self.engine.prefill_extract_staged(req, self.plane))
            self.pulled += 1
            log.info("queue prefill served: %d tokens, ticket %d",
                     prompt_len, ticket["id"])
            await self.client.publish(
                reply, {"first_token": first_token, "ticket": ticket})
        except Exception as exc:  # noqa: BLE001 — report to the requester
            self.failed += 1
            log.exception("queue prefill failed")
            if reply:
                try:
                    await self.client.publish(reply, {"error": str(exc)})
                except (ConnectionError, OSError):
                    pass


class QueuePrefillDispatcher:
    """Decode-worker side: enqueue under depth backpressure, await the
    reply, pull the parcel over the KV plane."""

    def __init__(self, client, model_name: str, plane_client,
                 max_queue_depth: int = 8, reply_timeout: float = 120.0):
        self.client = client
        self.queue = queue_name(model_name)
        self.plane_client = plane_client
        self.max_queue_depth = max_queue_depth
        self.reply_timeout = reply_timeout
        self.enqueued = 0
        self.backpressured = 0

    async def remote_prefill(self, req: PreprocessedRequest, context=None):
        """(first_token, parcel), or None (backpressure, timeout or a
        remote error: the caller prefills locally)."""
        depth = await self.client.queue_len(self.queue)
        if depth >= self.max_queue_depth:
            self.backpressured += 1
            log.info("prefill queue depth %d >= %d: prefilling locally",
                     depth, self.max_queue_depth)
            return None
        reply = REPLY_PREFIX + uuid.uuid4().hex
        sub = await self.client.subscribe(reply)
        try:
            item = {"req": req.to_wire(), "reply": reply,
                    "t_enq": time.time()}
            if context is not None:
                item["ctx"] = context.to_wire()
            await self.client.queue_push(self.queue, item)
            self.enqueued += 1
            try:
                msg = await asyncio.wait_for(sub.__aiter__().__anext__(),
                                             timeout=self.reply_timeout)
            except asyncio.TimeoutError:
                log.warning("prefill queue reply timed out after %.0fs",
                            self.reply_timeout)
                return None
            payload = msg["payload"]
            if "error" in payload:
                log.warning("queued prefill failed remotely: %s",
                            payload["error"])
                return None
            kv = await self.plane_client.pull(payload["ticket"])
            return payload["first_token"], kv
        finally:
            await sub.cancel()
