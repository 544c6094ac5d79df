"""Pre-warmed standby workers and the scale agent (copy of
``dynamo_tpu.llm.standby``): the worker side of fleet autoscaling.

A cold GPU worker pays for its weights and its window-program captures
(tens of seconds for llama-3-8b) before it serves; a **standby** pays
that up front and parks: weights loaded, programs captured, but
deregistered (no model card, no endpoint), announced on a lease-bound
``standby/`` key while it waits for one verb.

Coordinator schema (the reference's)::

    standby/<namespace>/<worker_hex> -> standby status (worker's lease)
    scale/<namespace>/<worker_hex>   -> ScaleDirective (issuer's lease)

A ``ScaleDirective`` is ``{"action": "promote"|"retire", "role", "epoch",
"issued_by", "cause", "drain_s"?}``:

- **promote** (a standby only): journals ``standby_promote``, drops the
  ``standby/`` key and starts the RoleManager, which builds the serving
  profile and registers the endpoints (the front's discovery then sees a
  new instance); it journals its own ``worker_join`` and records the
  join latency in ``standby_join_seconds``.
- **retire** (scale-in): ``RoleManager.retire()`` under the SAME lock
  and epoch fence as SetRole, so a retire racing a flip has one winner.
  The drain deregisters first and kills leftovers with typed
  ``incomplete:scale_in`` frames that migrate; then the worker's
  shutdown hook runs and the process exits with its lease. A retire of
  a still-parked standby just shrinks the pool.

Epochs are shared with role flips: the planner mints them above every
epoch visible in the fleet. A standby that dies mid-join loses its
lease; the planner then sees an orphaned promote and reaps it.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable

from dynamo_tpu_torch.llm.reconfig import RoleManager
from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.errors import RoleTransitionError
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.retry import Backoff, policies

log = get_logger("standby")

STANDBY_ROOT = "standby/"
SCALE_ROOT = "scale/"

#: The scale-directive verbs (anything else is malformed and ignored).
SCALE_ACTIONS = ("promote", "retire")


def standby_key(namespace: str, worker_id: int) -> str:
    """The lease-bound key a parked standby announces itself on."""
    return f"{STANDBY_ROOT}{namespace}/{worker_id:x}"


def scale_key(namespace: str, worker_id: int) -> str:
    """The directive key the worker watches for promote/retire verbs."""
    return f"{SCALE_ROOT}{namespace}/{worker_id:x}"


class StandbyState:
    """ScaleAgent lifecycle."""

    WARMING = "warming"
    READY = "ready"        # parked: warmed, deregistered, lease held
    PROMOTING = "promoting"
    ACTIVE = "active"      # serving (RoleManager started)
    RETIRED = "retired"


class ScaleAgent:
    """One worker's scale-directive intake, in either launch mode.

    ``standby=True`` parks the worker (runs ``warmup``, publishes the
    ``standby/`` key, does NOT start the RoleManager); ``standby=False``
    is a normal serving worker that still answers retire verbs so the
    planner can scale it in. The worker main starts the RoleManager
    itself in non-standby mode, exactly as before this module existed.
    """

    def __init__(self, runtime, roles: RoleManager, standby: bool = False,
                 namespace: str | None = None,
                 warmup: Callable | None = None,
                 status_extra: dict | None = None,
                 on_shutdown: Callable | None = None,
                 metrics=None):
        self._runtime = runtime
        self.roles = roles
        self.namespace = namespace or runtime.config.namespace
        self.standby = standby
        self._warmup = warmup
        self._extra = dict(status_extra or {})
        # What a completed retire runs (default: stop the process, so
        # the lease — and every lease-bound key — dies with it).
        self._on_shutdown = on_shutdown or runtime.shutdown
        self.state = StandbyState.ACTIVE
        self.join_seconds: float | None = None
        self.promotions = 0
        self._watch = None
        self._watch_task: asyncio.Task | None = None
        self._m_ready = self._m_promos = self._m_join = None
        if metrics is not None:
            m = metrics.namespace("standby")
            self._m_ready = m.gauge(
                "standby_ready",
                "1 while this worker is a parked pre-warmed standby")
            self._m_promos = m.counter(
                "standby_promotions_total",
                "Standby -> serving promotions on this worker")
            self._m_join = m.gauge(
                "standby_join_seconds",
                "Last promote-directive-to-serving join latency")

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        if self.roles._on_retired is None:
            self.roles._on_retired = self._shutdown
        if self.standby:
            self.state = StandbyState.WARMING
            if self._warmup is not None:
                res = self._warmup()
                if asyncio.iscoroutine(res):
                    await res
            self.state = StandbyState.READY
            await self._write_standby()
            if self._m_ready is not None:
                self._m_ready.set(1.0)
            journal.emit(EventKind.STANDBY_READY,
                         worker_id=f"{self._runtime.instance_id:x}",
                         **self._extra)
            log.info("standby parked (warmed, deregistered): %x",
                     self._runtime.instance_id)
        if self._runtime.has_discovery:
            client = self._runtime.require_coordinator()
            client.on_lease_recreated(self._on_lease_recreated)
            self._watch = await client.watch_prefix(
                scale_key(self.namespace, self._runtime.instance_id))
            for item in self._watch.snapshot:
                await self._apply(item["v"])
            self._watch_task = asyncio.create_task(self._watch_loop())

    async def stop(self) -> None:
        if self._watch_task:
            self._watch_task.cancel()
        if self._watch is not None:
            await self._watch.cancel()

    def _shutdown(self) -> None:
        try:
            self._on_shutdown()
        except Exception:  # noqa: BLE001 — a broken hook must not wedge
            log.exception("scale-in shutdown hook failed")

    async def _on_lease_recreated(self, _new_lease_id: int) -> None:
        if self.state in (StandbyState.WARMING, StandbyState.READY):
            await self._write_standby()

    # -- directive intake ------------------------------------------------------
    async def _apply(self, value) -> None:
        if not isinstance(value, dict) or value.get("action") \
                not in SCALE_ACTIONS:
            log.warning("malformed scale directive ignored: %r", value)
            return
        try:
            if value["action"] == "promote":
                await self._promote(value)
            else:
                await self._retire(value)
        except RoleTransitionError as exc:
            # Fencing rejections are normal under replay/races; the
            # typed decision is already journaled by the fence.
            log.info("scale directive fenced out: %s", exc)
        except (ValueError, TypeError) as exc:
            log.warning("malformed scale directive ignored: %s", exc)

    async def _watch_loop(self) -> None:
        """Same survival contract as the role-directive watch: anything
        short of cancellation re-establishes, or the worker would ignore
        the planner forever."""
        backoff = Backoff(policies.COORD_RECONNECT)
        while True:
            try:
                async for event in self._watch:
                    if event["event"] == "put":
                        await self._apply(event["value"])
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — re-establish, never die
                log.exception("scale directive watch failed; re-watching")
            await backoff.sleep()
            try:
                self._watch = await self._runtime.require_coordinator() \
                    .watch_prefix(scale_key(self.namespace,
                                            self._runtime.instance_id))
                for item in self._watch.snapshot:
                    await self._apply(item["v"])
                backoff.reset()
            except (ConnectionError, OSError, RuntimeError):
                log.warning("scale directive re-watch failed; will retry")

    # -- promote ---------------------------------------------------------------
    async def _promote(self, directive: dict) -> None:
        epoch = int(directive.get("epoch", 0))
        if self.state == StandbyState.ACTIVE:
            # Replay of the promote that already ran (watch reconnect
            # snapshot), or a planner re-issue that raced our join: a
            # noop either way — but fence FORWARD so the planner's GC
            # sees the directive applied and reaps it instead of
            # counting it as an action in flight forever.
            if epoch > self.roles.applied_epoch:
                self.roles.applied_epoch = epoch
                await self.roles._write_status()
                log.info("promote epoch %d on an already-active worker: "
                         "fenced forward", epoch)
            return
        if self.state != StandbyState.READY:
            log.info("promote while %s ignored", self.state)
            return
        if epoch <= self.roles.applied_epoch:
            log.info("stale promote epoch %d fenced (applied %d)",
                     epoch, self.roles.applied_epoch)
            return
        role = directive.get("role") or self.roles.role
        self.state = StandbyState.PROMOTING
        t0 = time.monotonic()
        promote_ref = journal.emit(
            EventKind.STANDBY_PROMOTE, cause=directive.get("cause"),
            worker_id=f"{self._runtime.instance_id:x}", role=role,
            epoch=epoch, issued_by=directive.get("issued_by", "?"))
        # Drop the standby key FIRST: the pool shrinks the moment the
        # promote starts, so a second scale-out can't double-book this
        # worker. If the join dies after this point the planner sees an
        # orphaned directive (no standby, no rolestatus) and promotes a
        # replacement.
        try:
            await self._runtime.require_coordinator().kv_delete(
                standby_key(self.namespace, self._runtime.instance_id))
        except (ConnectionError, OSError, RuntimeError):
            log.warning("standby key delete failed (coordinator down?); "
                        "lease expiry will reap it")
        if self._m_ready is not None:
            self._m_ready.set(0.0)
        self.roles.role = role
        self.roles.applied_epoch = epoch
        # The join must ride out a coordinator outage: a standby that
        # gave up mid-registration would be stuck — not parked, not
        # serving — forever. Transient transport errors retry under the
        # unified reconnect policy; real build bugs propagate.
        backoff = Backoff(policies.COORD_RECONNECT)
        while True:
            try:
                await self.roles.start()
                break
            except (ConnectionError, OSError, asyncio.TimeoutError):
                log.warning("standby join hit a transport error; "
                            "retrying", exc_info=True)
                # An attempt can fail AFTER the profile built (e.g. the
                # directive watch dial): tear the partial profile down
                # or the retry would register duplicate servers.
                if self.roles.profile is not None:
                    for server in self.roles.profile.servers:
                        try:
                            await server.shutdown()
                        except Exception:  # noqa: BLE001 — best effort
                            pass
                    await self.roles.profile.close()
                    self.roles.profile = None
                await backoff.sleep()
        self.join_seconds = time.monotonic() - t0
        self.promotions += 1
        self.state = StandbyState.ACTIVE
        if self._m_promos is not None:
            self._m_promos.inc()
        if self._m_join is not None:
            self._m_join.set(self.join_seconds)
        journal.emit(EventKind.WORKER_JOIN, cause=promote_ref,
                     instance=f"{self._runtime.instance_id:x}",
                     via="standby", role=role,
                     join_seconds=round(self.join_seconds, 3))
        log.info("standby promoted to %s in %.2fs (epoch %d)", role,
                 self.join_seconds, epoch)

    # -- retire ----------------------------------------------------------------
    async def _retire(self, directive: dict) -> None:
        epoch = int(directive.get("epoch", 0))
        if self.state in (StandbyState.WARMING, StandbyState.READY,
                          StandbyState.PROMOTING):
            # Shrinking the standby pool: nothing serves, nothing drains.
            if epoch <= self.roles.applied_epoch:
                return
            self.roles.applied_epoch = epoch
            self.state = StandbyState.RETIRED
            journal.emit(EventKind.SCALE_RETIRE,
                         cause=directive.get("cause"), phase="standby",
                         epoch=epoch, outcome="ok")
            try:
                await self._runtime.require_coordinator().kv_delete(
                    standby_key(self.namespace, self._runtime.instance_id))
            except (ConnectionError, OSError, RuntimeError):
                pass
            if self._m_ready is not None:
                self._m_ready.set(0.0)
            self._shutdown()
            return
        await self.roles.retire(
            epoch, issued_by=str(directive.get("issued_by", "directive")),
            drain_s=directive.get("drain_s"),
            cause=directive.get("cause"))
        self.state = StandbyState.RETIRED

    # -- status ----------------------------------------------------------------
    def standby_status(self) -> dict:
        return {
            "worker": f"{self._runtime.instance_id:x}",
            "state": self.state,
            "role": self.roles.role,
            "warmed": self.state in (StandbyState.READY,
                                     StandbyState.PROMOTING,
                                     StandbyState.ACTIVE),
            "ts": time.time(),
            **self._extra,
        }

    async def _write_standby(self) -> None:
        try:
            await self._runtime.require_coordinator().kv_put(
                standby_key(self.namespace, self._runtime.instance_id),
                self.standby_status(), use_primary_lease=True)
        except (ConnectionError, OSError, RuntimeError):
            log.warning("standby status write failed (coordinator "
                        "down?); will replay on reconnect")
