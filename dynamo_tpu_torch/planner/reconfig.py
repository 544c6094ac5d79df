"""Planner-driven role reconfiguration (copy of
``dynamo_tpu.planner.reconfig``): which worker flips, and when.

The worker side (``llm/reconfig.py``) makes a flip safe; this loop makes
it useful. From the SLO plane's TTFT/ITL pressure (``runtime/slo.py``
``pressure()``), the prefill queue's depth (``llm/prefill_queue.py``)
and the fleet's role mix it re-partitions a fixed pool between prefill
and decode.

Guard rails (each knob is ``DTPU_PLANNER_RECONFIG_<FIELD>``):

- hysteresis: a direction must be signalled for
  ``hysteresis_intervals`` consecutive steps before a directive goes;
- cooldown: at least ``cooldown_s`` between issued flips;
- at most one flip in flight fleet-wide (a worker ``draining`` or
  ``flipping``, or a directive not yet applied, holds new ones back);
- role-mix floors: never below ``min_prefill`` prefill-capable or
  ``min_decode`` decode-capable workers.

Directives ride the planner's primary lease with an epoch above every
epoch visible in the fleet, so a directive of a dead planner never
applies late.
"""

from __future__ import annotations

import dataclasses
import time

from dynamo_tpu_torch.llm.reconfig import (ROLE_ROOT, ROLE_STATUS_ROOT, RoleState,
                                     role_key)
from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.reconfig")

#: Which roles can absorb prefill / decode work (agg does both).
PREFILL_CAPABLE = ("prefill", "agg")
DECODE_CAPABLE = ("decode", "agg")


@dataclasses.dataclass
class ReconfigConfig:
    """Role-flip decision knobs. All plain scalars so the generic
    ``DTPU_PLANNER_RECONFIG_<FIELD>`` env override applies
    (runtime/config.py ``_apply_scalar_env``)."""

    enabled: bool = False
    # Seconds between issued flips, fleet-wide.
    cooldown_s: float = 120.0
    # Consecutive planner steps a flip signal must persist.
    hysteresis_intervals: int = 2
    # Role-mix floors (capable counts: agg counts for both).
    min_prefill: int = 1
    min_decode: int = 1
    # SLO pressure level (SloPressure.level 0..3) at which a failing
    # ttft/itl target argues for moving capacity.
    pressure_level: int = 2
    # Prefill-queue depth that argues for more prefill capacity even
    # without an SLO signal / that must be clear before giving any up.
    queue_depth_high: int = 4
    queue_depth_low: int = 1
    # Drain budget passed on the directive; 0 = worker default
    # (retire_drain_s).
    drain_s: float = 0.0
    # A live worker stuck draining/flipping longer than this stops
    # blocking new decisions (its status still WARNs in doctor.py); 0
    # disables the escape hatch.
    stuck_flip_s: float = 600.0


def apply_reconfig_env(cfg: ReconfigConfig) -> ReconfigConfig:
    """Overlay DTPU_PLANNER_RECONFIG_* env vars onto ``cfg``."""
    from dynamo_tpu_torch.runtime.config import _apply_scalar_env
    _apply_scalar_env("PLANNER_RECONFIG", cfg)
    return cfg


class RoleReconfigurator:
    """One planner's role-flip decision loop.

    ``pressure_fn`` returns the current SloPressure (or None when no SLO
    plane is reachable); ``queue_depth_fn`` returns the prefill queue
    depth (or None). Both are injectable for tests; the planner wires
    defaults from the process-global SLO plane and the coordinator
    queue. ``clock`` is injectable so cooldown is fake-clock testable.
    """

    def __init__(self, client, namespace: str,
                 config: ReconfigConfig | None = None,
                 pressure_fn=None, queue_depth_fn=None,
                 clock=time.monotonic):
        self._client = client
        self.namespace = namespace
        self.cfg = config or ReconfigConfig()
        self._pressure_fn = pressure_fn
        self._queue_depth_fn = queue_depth_fn
        self._clock = clock
        self._last_flip_t: float | None = None
        self._streak = {"to_prefill": 0, "to_decode": 0}
        self._last_decision_ref: str | None = None
        self.issued: list[dict] = []

    # -- fleet view -----------------------------------------------------------
    async def fleet(self) -> list[dict]:
        """Live worker role statuses (lease-bound: dead workers absent)."""
        items = await self._client.kv_get_prefix(
            f"{ROLE_STATUS_ROOT}{self.namespace}/")
        return [it["v"] for it in items if isinstance(it.get("v"), dict)]

    async def pending_directives(self) -> list[dict]:
        items = await self._client.kv_get_prefix(
            f"{ROLE_ROOT}{self.namespace}/")
        out = []
        for it in items:
            v = it.get("v")
            if isinstance(v, dict):
                out.append({"key": it["k"], **v})
        return out

    # -- one decision step ----------------------------------------------------
    async def step(self) -> dict:
        """Observe signals, apply guard rails, maybe issue ONE directive.
        Returns a decision record (always; ``action`` says what happened)."""
        cfg = self.cfg
        pressure = self._pressure_fn() if self._pressure_fn else None
        depth = (await self._maybe_depth()
                 if self._queue_depth_fn else None)
        fleet = await self.fleet()
        directives = await self.pending_directives()
        await self._gc_directives(fleet, directives)
        record: dict = {
            "pool": "reconfig",
            "pressure": pressure.to_wire() if pressure else None,
            "queue_depth": depth,
            "roles": {s["worker"]: s.get("role") for s in fleet},
            "action": "none",
        }
        want = self._signal(pressure, depth)
        for k in self._streak:
            self._streak[k] = self._streak[k] + 1 if want == k else 0
        record["signal"] = want
        record["streaks"] = dict(self._streak)
        if want is None:
            return record
        if self._streak[want] < cfg.hysteresis_intervals:
            record["action"] = "hysteresis"
            return self._journal_decision(record)
        now = self._clock()
        if (self._last_flip_t is not None
                and now - self._last_flip_t < cfg.cooldown_s):
            record["action"] = "cooldown"
            return self._journal_decision(record)
        if self._flip_in_flight(fleet, directives):
            record["action"] = "flip_in_flight"
            return self._journal_decision(record)
        target_role = "prefill" if want == "to_prefill" else "decode"
        candidate = self._candidate(fleet, target_role)
        if candidate is None:
            record["action"] = "bounded"
            return self._journal_decision(record)
        epoch = self._next_epoch(fleet, directives)
        self._journal_decision(dict(record, action="flip",
                                    worker=candidate["worker"],
                                    target_role=target_role, epoch=epoch))
        directive = await self.issue(candidate["worker"], target_role,
                                     epoch, cause=self._last_decision_ref)
        self._last_flip_t = now
        self._streak[want] = 0
        record["action"] = "flip"
        record["directive"] = directive
        return record

    def _journal_decision(self, record: dict) -> dict:
        """Every non-trivial planner decision (including the guard rails
        that SUPPRESSED a flip) lands on the decision plane with its
        input signals — 'why did/didn't the planner act' is answerable
        from the timeline. The flip decision's ref rides the directive
        so the worker's role_flip_requested chains back to it."""
        # NB ``worker=`` is emit()'s origin override — the flip TARGET
        # rides as a plain attr so the decision stays attributed to the
        # planner and its ref can't collide with the worker's own seqs.
        self._last_decision_ref = journal.emit(
            EventKind.PLANNER_DECISION,
            action=record.get("action"), signal=record.get("signal"),
            pressure=record.get("pressure"),
            queue_depth=record.get("queue_depth"),
            roles=record.get("roles"),
            target_worker=record.get("worker"),
            target_role=record.get("target_role"))
        return record

    async def issue(self, worker_hex: str, role: str, epoch: int,
                    issued_by: str = "planner",
                    cause: str | None = None) -> dict:
        """Write one SetRole directive on OUR lease (planner death ->
        lease expiry -> directive key deleted -> stale flip fenced).
        ``cause`` (the planner_decision journal ref) rides the directive
        into the worker's role_flip_* events."""
        directive = {"role": role, "epoch": int(epoch),
                     "issued_by": issued_by, "ts": time.time()}
        if cause is not None:
            directive["cause"] = cause
        if self.cfg.drain_s > 0:
            directive["drain_s"] = self.cfg.drain_s
        await self._client.kv_put(
            role_key(self.namespace, int(worker_hex, 16)), directive,
            use_primary_lease=True)
        self.issued.append({"worker": worker_hex, **directive})
        log.info("issued SetRole %s -> %s (epoch %d)", worker_hex, role,
                 epoch)
        return {"worker": worker_hex, **directive}

    # -- internals ------------------------------------------------------------
    async def _maybe_depth(self):
        try:
            return await self._queue_depth_fn()
        except (ConnectionError, OSError, RuntimeError):
            return None

    def _signal(self, pressure, depth) -> str | None:
        """Which direction (if any) the current signals argue for."""
        cfg = self.cfg
        paging = (pressure is not None
                  and pressure.level >= cfg.pressure_level)
        ttft_hot = paging and "ttft" in pressure.failing
        itl_hot = paging and "itl" in pressure.failing
        deep = depth is not None and depth >= cfg.queue_depth_high
        shallow = depth is None or depth <= cfg.queue_depth_low
        if (ttft_hot or deep) and not itl_hot:
            return "to_prefill"
        if itl_hot and shallow and not ttft_hot:
            return "to_decode"
        return None

    def _flip_in_flight(self, fleet: list[dict],
                        directives: list[dict]) -> bool:
        cfg = self.cfg
        now = time.time()
        by_worker = {s["worker"]: s for s in fleet}
        for s in fleet:
            if s.get("state") in (RoleState.DRAINING, RoleState.FLIPPING):
                if (cfg.stuck_flip_s > 0
                        and now - float(s.get("ts") or now) > cfg.stuck_flip_s):
                    log.warning("ignoring stuck flip on %s (state %s for "
                                ">%.0fs)", s["worker"], s.get("state"),
                                cfg.stuck_flip_s)
                    continue
                return True
        for d in directives:
            worker = d["key"].rsplit("/", 1)[-1]
            status = by_worker.get(worker)
            if status is None:
                continue  # dead worker's directive; _gc_directives reaps it
            if int(d.get("epoch", 0)) > int(status.get("epoch", 0)):
                return True
        return False

    def _candidate(self, fleet: list[dict], target_role: str) -> dict | None:
        """Pick the worker to flip toward ``target_role``, respecting the
        role-mix floors. Prefers the least-loaded serving worker of the
        giving role (fewest in-flight streams drain fastest)."""
        cfg = self.cfg
        source_role = "decode" if target_role == "prefill" else "prefill"
        serving = [s for s in fleet
                   if s.get("state") == RoleState.SERVING
                   and s.get("role") == source_role]
        if not serving:
            return None
        prefill_n = sum(1 for s in fleet
                        if s.get("role") in PREFILL_CAPABLE)
        decode_n = sum(1 for s in fleet if s.get("role") in DECODE_CAPABLE)
        if target_role == "prefill" and decode_n - 1 < cfg.min_decode:
            return None
        if target_role == "decode" and prefill_n - 1 < cfg.min_prefill:
            return None
        return min(serving, key=lambda s: int(s.get("inflight") or 0))

    def _next_epoch(self, fleet: list[dict],
                    directives: list[dict]) -> int:
        top = 0
        for s in fleet:
            top = max(top, int(s.get("epoch") or 0))
        for d in directives:
            top = max(top, int(d.get("epoch") or 0))
        return top + 1

    async def _gc_directives(self, fleet: list[dict],
                             directives: list[dict]) -> None:
        """Reap directives that are applied (worker's epoch caught up) or
        orphaned (worker gone): the directive key is a pending verb, not
        a desired-state record — leaving it would replay the flip into
        every watch reconnect until the issuer dies."""
        by_worker = {s["worker"]: s for s in fleet}
        for d in directives:
            worker = d["key"].rsplit("/", 1)[-1]
            status = by_worker.get(worker)
            applied = (status is not None
                       and int(status.get("epoch") or 0)
                       >= int(d.get("epoch") or 0))
            if status is None or applied:
                try:
                    await self._client.kv_delete(d["key"])
                except (ConnectionError, OSError, RuntimeError):
                    pass
