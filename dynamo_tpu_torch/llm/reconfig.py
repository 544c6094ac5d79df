"""Live role changes of a worker (copy of ``dynamo_tpu.llm.reconfig``):
the worker side of the SetRole protocol.

A running worker flips between ``prefill``, ``decode`` and ``agg``
without dropping an in-flight request and without reloading weights:

- A ``SetRole`` verb moves the worker through the state machine
  ``serving -> draining -> flipping -> serving``. The drain deregisters
  the old serving profile's endpoint servers (routers stop picking the
  worker at once); in-flight streams finish within the drain window or
  are killed with a typed ``incomplete:role_flip`` frame, which the
  caller's migration (``llm/migration.py``) re-issues on another worker
  and the request ledger records as ``migration_reason="role_flip"``.
- The flip tears the old profile's machinery down (queue workers,
  prefill clients, threshold watches) and builds the new role's profile
  around the SAME engine object: no weight reload, no new program.
- Every directive is epoch-fenced: a worker applies a directive only if
  its epoch is above the last applied one, so duplicated or reordered
  verbs ack ``duplicate`` or reject typed (``RoleTransitionError``), and
  a directive replayed by a watch reconnect cannot re-run a finished
  flip. Directives a planner issues ride the planner's lease
  (``planner/reconfig.py``): a planner that dies loses them.

Coordinator schema (the reference's keys and values)::

    role/<namespace>/<worker_hex>        -> RoleDirective (issuer's lease)
    rolestatus/<namespace>/<worker_hex>  -> worker status (worker's lease)

The status key rides the worker's primary lease, so a worker that dies
mid-drain vanishes from the fleet view while its streams migrate; the
lease-recreated callback re-puts it after a coordinator restart.

Observability: ``role_flips_total{from,to,outcome}``, the
``worker_role`` gauge, a ``role.flip`` span with ``role.drain`` and
``role.reregister`` children, and the ``role_flip_*`` journal events.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.errors import RoleTransitionError
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.retry import Backoff, policies
from dynamo_tpu_torch.runtime.tracing import span

log = get_logger("reconfig")

#: The roles a worker can serve. ``agg`` = fully local prefill+decode.
ROLES = ("prefill", "decode", "agg")

#: Why a stream died during a drain — the typed migration reason.
DRAIN_REASON = "role_flip"

#: The scale-in flavor: a retire drain kills leftovers with
#: ``incomplete:scale_in`` frames so the ledger can attribute the
#: migration cost to autoscaling, not to role flips.
SCALE_IN_REASON = "scale_in"

ROLE_ROOT = "role/"
ROLE_STATUS_ROOT = "rolestatus/"


def role_key(namespace: str, worker_id: int) -> str:
    """The directive key the worker watches for SetRole verbs."""
    return f"{ROLE_ROOT}{namespace}/{worker_id:x}"


def role_status_key(namespace: str, worker_id: int) -> str:
    """The status key the worker publishes its state machine on."""
    return f"{ROLE_STATUS_ROOT}{namespace}/{worker_id:x}"


class RoleState:
    """Worker role state machine states."""

    SERVING = "serving"
    DRAINING = "draining"
    FLIPPING = "flipping"
    # Terminal: a scale-in retire drained this worker out of the fleet
    # (llm/standby.py scale directives). The status key vanishes with
    # the worker's lease moments later; "retired" is the short-lived
    # honest answer in between.
    RETIRED = "retired"


#: role_flips_total outcome vocabulary. ``ok``/``failed`` terminate a
#: real transition; the rest are fencing decisions on the verb itself.
FLIP_OUTCOMES = ("ok", "failed", "noop", "duplicate", "rejected_stale",
                 "rejected_busy")


class ServingProfile:
    """Everything one role serves: endpoint servers plus the closers for
    role-specific machinery (prefill queue workers, disagg clients and
    config watchers, queue dispatchers). Built per role by the worker
    main's profile factory; the engine itself lives OUTSIDE the profile
    and survives flips."""

    def __init__(self, role: str):
        self.role = role
        self.servers: list = []          # EndpointServer instances
        self._closers: list[tuple[str, Callable[[], Awaitable]]] = []
        self.pausables: list = []        # objects with .pause() (queue pulls)

    def add_server(self, server) -> "ServingProfile":
        self.servers.append(server)
        return self

    def add_closer(self, name: str, fn: Callable[[], Awaitable]
                   ) -> "ServingProfile":
        """Async teardown for role-specific machinery, run (reverse
        order) during the flip phase — after the drain."""
        self._closers.append((name, fn))
        return self

    def add_pausable(self, obj) -> "ServingProfile":
        """Something with a ``pause()`` method that must stop pulling
        NEW work the moment the drain starts (QueuePrefillWorker: a
        draining prefill worker must leave queue items to its peers)."""
        self.pausables.append(obj)
        return self

    @property
    def inflight(self) -> int:
        return sum(len(getattr(s, "_inflight", ())) for s in self.servers)

    async def drain(self, drain_s: float, reason: str = DRAIN_REASON) -> int:
        """Deregister every server and drain in-flight streams up to the
        deadline; leftovers are killed with typed incomplete frames.
        Returns how many streams the servers sent back that way."""
        for obj in self.pausables:
            try:
                obj.pause()
            except Exception:  # noqa: BLE001 — pausing is best-effort
                log.exception("pause during drain failed")
        for server in self.servers:
            await server.shutdown(drain_s=drain_s, reason=reason)
        return sum(getattr(s, "cut_streams", 0) for s in self.servers)

    async def close(self) -> None:
        """Tear down role-specific machinery (watchers, clients, queue
        workers). Servers are already down after drain()."""
        for name, fn in reversed(self._closers):
            try:
                await fn()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — teardown must not wedge a flip
                log.exception("profile closer %s failed", name)
        self._closers.clear()
        self.servers.clear()
        self.pausables.clear()


class RoleManager:
    """Worker-side owner of the role state machine.

    ``build_profile(role) -> ServingProfile`` is the only hook a worker
    main provides: it registers the role's endpoints around the shared
    engine. The manager serializes SetRole verbs (from the coordinator
    directive watch AND the status server's HTTP control path) through
    one lock, fences them by epoch, and publishes its state on the
    coordinator for the planner/doctor fleet view.
    """

    def __init__(self, runtime, build_profile:
                 Callable[[str], Awaitable[ServingProfile]],
                 role: str = "agg", namespace: str | None = None,
                 drain_s: float | None = None,
                 status_extra: dict | None = None):
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r} (want one of {ROLES})")
        self._runtime = runtime
        self._build = build_profile
        self.role = role
        self.namespace = namespace or runtime.config.namespace
        self.state = RoleState.SERVING
        self.applied_epoch = 0
        self.target_role: str | None = None
        self._inflight_epoch: int | None = None
        self.last_outcome: dict | None = None
        self.profile: ServingProfile | None = None
        self.drain_s = (drain_s if drain_s is not None
                        else runtime.config.retire_drain_s)
        self._extra = dict(status_extra or {})
        # Scale-in hook: called once after a retire() drain completes
        # (worker mains wire runtime.shutdown so the process exits and
        # its lease — and status key — die with it).
        self._on_retired: Callable | None = None
        self._lock = asyncio.Lock()
        self._watch = None
        self._watch_task: asyncio.Task | None = None
        self.flips = 0
        # Streams this worker's drains (flips and a retire) cut or
        # refused: each migrates with the drain's typed reason.
        self.cut_streams = 0
        metrics = getattr(runtime, "metrics", None)
        self._m_flips = self._m_role = None
        if metrics is not None:
            self._m_flips = metrics.counter(
                "role_flips_total",
                "Worker role transitions by source/target/outcome",
                ["from", "to", "outcome"])
            self._m_role = metrics.gauge(
                "worker_role", "Current serving role (1 on exactly one "
                "role label per worker)", ["role"])

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        """Build the initial profile, publish status, watch directives."""
        self.profile = await self._build(self.role)
        self._set_role_gauge()
        if self._runtime.has_discovery:
            client = self._runtime.require_coordinator()
            await self._write_status()
            client.on_lease_recreated(self._on_lease_recreated)
            self._watch = await client.watch_prefix(
                role_key(self.namespace, self._runtime.instance_id))
            for item in self._watch.snapshot:
                # A directive issued while we were (re)starting: apply it
                # now — epoch fencing makes replays harmless.
                await self._apply_directive(item["v"])
            self._watch_task = asyncio.create_task(self._watch_loop())

    async def stop(self) -> None:
        if self._watch_task:
            self._watch_task.cancel()
        if self._watch is not None:
            await self._watch.cancel()
        if self.profile is not None:
            for server in self.profile.servers:
                await server.shutdown()
            await self.profile.close()
            self.profile = None

    async def _on_lease_recreated(self, _new_lease_id: int) -> None:
        """Status rides our primary lease: re-put after a regrant so the
        fleet view doesn't silently lose this worker."""
        await self._write_status()

    # -- the SetRole verb -----------------------------------------------------
    async def set_role(self, role: str, epoch: int,
                       issued_by: str = "operator",
                       drain_s: float | None = None,
                       cause: str | None = None) -> dict:
        """Apply one SetRole directive. ``cause`` is the issuer's
        journal ref (a planner_decision event rides the directive) so
        the worker's flip events chain back to the decision that issued
        them. Returns the outcome record; raises RoleTransitionError
        (typed, wire-prefixed) on fencing rejections — unknown role,
        stale/duplicate epoch, or a conflicting flip already in
        flight."""
        if role not in ROLES:
            raise RoleTransitionError(
                f"unknown role {role!r} (want one of {ROLES})")
        if self.state == RoleState.RETIRED:
            raise RoleTransitionError(
                "worker is retired (scale-in drained it); no further "
                "role transitions apply")
        epoch = int(epoch)
        if self._lock.locked():
            # Fast-path fencing against the in-flight flip WITHOUT
            # queueing behind it: a duplicate of the running directive is
            # acknowledged, anything else is rejected busy.
            if (self.target_role == role
                    and self._inflight_epoch == epoch):
                return {"from": self.role, "to": role, "epoch": epoch,
                        "outcome": "duplicate", "state": self.state}
            self._note_fence(self.role, role, epoch, "rejected_busy",
                             cause=cause)
            raise RoleTransitionError(
                f"flip to {self.target_role!r} (epoch "
                f"{self._inflight_epoch}) in flight; retry after it "
                "converges")
        async with self._lock:
            if self.state == RoleState.RETIRED:
                # A retire won the race for the lock: this worker is out
                # of the fleet, the flip must target someone else.
                self._note_fence(self.role, role, epoch, "rejected_stale",
                                 cause=cause)
                raise RoleTransitionError(
                    "worker retired while the flip waited; no further "
                    "role transitions apply")
            if epoch <= self.applied_epoch:
                if role == self.role and epoch == self.applied_epoch:
                    # Exact duplicate of the applied directive: idempotent.
                    return {"from": self.role, "to": role, "epoch": epoch,
                            "outcome": "duplicate", "state": self.state}
                self._note_fence(self.role, role, epoch, "rejected_stale",
                                 cause=cause)
                raise RoleTransitionError(
                    f"stale epoch {epoch} (applied epoch "
                    f"{self.applied_epoch}, role {self.role!r})")
            if role == self.role:
                # Fence forward without a transition.
                self.applied_epoch = epoch
                self.last_outcome = self._outcome(role, role, epoch, "noop")
                journal.emit(EventKind.ROLE_FLIP_DONE, cause=cause,
                             **{"from": role, "to": role, "epoch": epoch,
                                "outcome": "noop"})
                await self._write_status()
                return self.last_outcome
            return await self._flip(role, epoch, issued_by, drain_s, cause)

    async def _flip(self, role: str, epoch: int, issued_by: str,
                    drain_s: float | None,
                    cause: str | None = None) -> dict:
        old = self.role
        self.target_role = role
        self._inflight_epoch = epoch
        outcome, error = "ok", None
        budget = self.drain_s if drain_s is None else drain_s
        log.info("role flip %s -> %s (epoch %d, by %s): draining up to "
                 "%.1fs", old, role, epoch, issued_by, budget)
        # Every state-machine edge lands on the decision plane, each
        # edge caused by the previous one (and the first by the
        # issuer's decision event when the directive carried its ref).
        requested_ref = journal.emit(
            EventKind.ROLE_FLIP_REQUESTED, cause=cause,
            **{"from": old, "to": role, "epoch": epoch,
               "issued_by": issued_by})
        with span("role.flip", to=role, epoch=epoch, issued_by=issued_by,
                  **{"from": old}) as sp:
            try:
                self.state = RoleState.DRAINING
                drain_ref = journal.emit(
                    EventKind.ROLE_FLIP_DRAINING, cause=requested_ref,
                    **{"from": old, "to": role, "epoch": epoch,
                       "inflight": self.profile.inflight,
                       "drain_s": budget})
                requested_ref = drain_ref
                await self._write_status()
                with span("role.drain", inflight=self.profile.inflight):
                    self.cut_streams += await self.profile.drain(
                        budget, reason=DRAIN_REASON)
                self.state = RoleState.FLIPPING
                await self._write_status()
                with span("role.reregister"):
                    await self.profile.close()
                    self.profile = None
                    self.profile = await self._build_with_retry(role)
                self.role = role
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — typed outcome, no wedge
                outcome, error = "failed", f"{type(exc).__name__}: {exc}"
                log.exception("role flip %s -> %s failed", old, role)
                if self.profile is None:
                    # Roll back to serving the OLD role rather than
                    # leaving the worker serving nothing.
                    try:
                        self.profile = await self._build_with_retry(old)
                    except Exception:  # noqa: BLE001 — report, stay degraded
                        outcome = "failed_unserved"
                        log.exception("rollback to role %s failed: worker "
                                      "is serving NOTHING", old)
            finally:
                self.applied_epoch = epoch
                self.state = RoleState.SERVING
                self.target_role = None
                self._inflight_epoch = None
                self.flips += 1
                self.last_outcome = self._outcome(old, role, epoch, outcome,
                                                  error)
                journal.emit(EventKind.ROLE_FLIP_DONE, cause=requested_ref,
                             **{"from": old, "to": role, "epoch": epoch,
                                "outcome": outcome,
                                **({"error": error} if error else {})})
                sp.set(outcome=outcome)
                if self._m_flips is not None:
                    self._m_flips.inc(**{"from": old, "to": role,
                                         "outcome": outcome})
                self._set_role_gauge()
                await self._write_status()
        log.info("role flip %s -> %s (epoch %d): %s", old, role, epoch,
                 outcome)
        return self.last_outcome

    # -- the Retire verb (scale-in; planner/capacity.py) ----------------------
    async def retire(self, epoch: int, issued_by: str = "planner",
                     drain_s: float | None = None,
                     cause: str | None = None) -> dict:
        """Drain this worker OUT of the fleet (scale-in). Shares the
        SetRole lock and epoch fence, so a retire racing a role flip
        resolves to exactly one winner — the loser rejects typed
        (RoleTransitionError), never both. The drain reuses the flip
        machinery with reason ``scale_in``: deregister-first, in-flight
        streams finish within the budget or are killed with typed
        ``incomplete:scale_in`` frames that migrate. On completion the
        ``on_retired`` callback (worker main: runtime.shutdown) fires.
        """
        epoch = int(epoch)
        if self.state == RoleState.RETIRED:
            if epoch == self.applied_epoch:
                return {"action": "retire", "epoch": epoch,
                        "outcome": "duplicate", "state": self.state}
            raise RoleTransitionError("worker is already retired")
        if self._lock.locked():
            if self.target_role is None and self._inflight_epoch == epoch:
                # Duplicate of the running retire: acknowledged.
                return {"action": "retire", "epoch": epoch,
                        "outcome": "duplicate", "state": self.state}
            self._note_retire_fence(epoch, "rejected_busy", cause=cause)
            raise RoleTransitionError(
                f"transition (epoch {self._inflight_epoch}) in flight; "
                "retire rejected")
        async with self._lock:
            if epoch <= self.applied_epoch:
                self._note_retire_fence(epoch, "rejected_stale", cause=cause)
                raise RoleTransitionError(
                    f"stale retire epoch {epoch} (applied epoch "
                    f"{self.applied_epoch})")
            self._inflight_epoch = epoch
            budget = self.drain_s if drain_s is None else drain_s
            log.info("scale-in retire (epoch %d, by %s): draining up to "
                     "%.1fs", epoch, issued_by, budget)
            requested_ref = journal.emit(
                EventKind.SCALE_RETIRE, cause=cause, phase="draining",
                epoch=epoch, issued_by=issued_by,
                inflight=self.profile.inflight if self.profile else 0,
                drain_s=budget)
            outcome, error = "ok", None
            with span("role.retire", epoch=epoch, issued_by=issued_by) as sp:
                try:
                    self.state = RoleState.DRAINING
                    await self._write_status()
                    if self.profile is not None:
                        with span("role.drain",
                                  inflight=self.profile.inflight):
                            self.cut_streams += await self.profile.drain(
                                budget, reason=SCALE_IN_REASON)
                        await self.profile.close()
                        self.profile = None
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # noqa: BLE001 — typed outcome
                    outcome = "failed"
                    error = f"{type(exc).__name__}: {exc}"
                    log.exception("scale-in drain failed; retiring anyway")
                finally:
                    self.applied_epoch = epoch
                    self.state = RoleState.RETIRED
                    self._inflight_epoch = None
                    self.last_outcome = {
                        "action": "retire", "epoch": epoch,
                        "outcome": outcome, "ts": time.time(),
                        **({"error": error} if error else {})}
                    journal.emit(EventKind.SCALE_RETIRE, cause=requested_ref,
                                 phase="done", epoch=epoch, outcome=outcome)
                    sp.set(outcome=outcome)
                    await self._write_status()
            log.info("scale-in retire (epoch %d): %s", epoch, outcome)
        if self._on_retired is not None:
            try:
                res = self._on_retired()
                if asyncio.iscoroutine(res):
                    await res
            except Exception:  # noqa: BLE001 — shutdown hook best-effort
                log.exception("on_retired hook failed")
        return self.last_outcome

    def _note_retire_fence(self, epoch: int, outcome: str,
                           cause: str | None = None) -> None:
        self.last_outcome = {"action": "retire", "epoch": epoch,
                             "outcome": outcome, "ts": time.time()}
        journal.emit(EventKind.SCALE_RETIRE, cause=cause, phase="rejected",
                     epoch=epoch, outcome=outcome)
        if self._m_flips is not None:
            self._m_flips.inc(**{"from": self.role, "to": "retired",
                                 "outcome": outcome})

    async def _build_with_retry(self, role: str) -> ServingProfile:
        """Build a profile, riding out coordinator outages: registration
        needs the control plane, and a flip that straddles a coordinator
        restart must converge once it returns (transient transport
        errors only — real build bugs propagate immediately)."""
        backoff = Backoff(policies.COORD_RECONNECT)
        while True:
            try:
                return await self._build(role)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                log.warning("profile build for role %s hit a transport "
                            "error; retrying", role, exc_info=True)
                await backoff.sleep()

    # -- directive watch ------------------------------------------------------
    async def _apply_directive(self, value) -> None:
        if not isinstance(value, dict) or "role" not in value:
            log.warning("malformed role directive ignored: %r", value)
            return
        try:
            await self.set_role(
                str(value["role"]), int(value.get("epoch", 0)),
                issued_by=str(value.get("issued_by", "directive")),
                drain_s=value.get("drain_s"),
                cause=value.get("cause"))
        except RoleTransitionError as exc:
            # Fencing rejections are normal under replay/duplication;
            # the typed decision is visible in status/metrics.
            log.info("role directive fenced out: %s", exc)
        except (ValueError, TypeError) as exc:
            log.warning("malformed role directive ignored: %s", exc)

    async def _watch_loop(self) -> None:
        """Directive intake. Must survive anything short of cancellation:
        a dead watch loop would strand the worker in its launch role
        forever while the planner keeps (re)issuing flips."""
        backoff = Backoff(policies.COORD_RECONNECT)
        while True:
            try:
                async for event in self._watch:
                    if event["event"] == "put":
                        await self._apply_directive(event["value"])
                    # delete = issuer revoked (or its lease died). An
                    # un-started directive simply never applies; a
                    # running flip converges forward — both consistent.
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — re-establish, never die
                log.exception("role directive watch failed; re-watching")
            await backoff.sleep()
            try:
                self._watch = await self._runtime.require_coordinator() \
                    .watch_prefix(role_key(self.namespace,
                                           self._runtime.instance_id))
                for item in self._watch.snapshot:
                    await self._apply_directive(item["v"])
                backoff.reset()
            except (ConnectionError, OSError, RuntimeError):
                log.warning("role directive re-watch failed; will retry")

    # -- status ---------------------------------------------------------------
    def status(self) -> dict:
        """The worker's role status (also the coordinator payload and the
        status server's GET /control/role body)."""
        return {
            "worker": f"{self._runtime.instance_id:x}",
            "role": self.role,
            "state": self.state,
            "epoch": self.applied_epoch,
            "target_role": self.target_role,
            "inflight": self.profile.inflight if self.profile else 0,
            "flips": self.flips,
            "last_outcome": self.last_outcome,
            "ts": time.time(),
            **self._extra,
        }

    async def _write_status(self) -> None:
        """Best-effort status publish (worker's primary lease). A flip
        must not wedge on a coordinator outage: the lease-recreated
        callback replays the final state after reconnect."""
        if not self._runtime.has_discovery:
            return
        try:
            await self._runtime.require_coordinator().kv_put(
                role_status_key(self.namespace, self._runtime.instance_id),
                self.status(), use_primary_lease=True)
        except (ConnectionError, OSError, RuntimeError):
            log.warning("role status write failed (coordinator down?); "
                        "will replay on reconnect")

    def _outcome(self, old: str, new: str, epoch: int, outcome: str,
                 error: str | None = None) -> dict:
        rec = {"from": old, "to": new, "epoch": epoch, "outcome": outcome,
               "ts": time.time()}
        if error:
            rec["error"] = error
        return rec

    def _note_fence(self, old: str, new: str, epoch: int,
                    outcome: str, cause: str | None = None) -> None:
        self.last_outcome = self._outcome(old, new, epoch, outcome)
        journal.emit(EventKind.ROLE_FLIP_REJECTED, cause=cause,
                     **{"from": old, "to": new, "epoch": epoch,
                        "outcome": outcome})
        if self._m_flips is not None:
            self._m_flips.inc(**{"from": old, "to": new, "outcome": outcome})

    def _set_role_gauge(self) -> None:
        if self._m_role is None:
            return
        for r in ROLES:
            self._m_role.set(1.0 if r == self.role else 0.0, role=r)
