"""SLA-driven fleet autoscaling (copy of ``dynamo_tpu.planner.capacity``):
the live capacity model and the scaler loop.

- **CapacityModel** turns observed demand into a target worker count.
  Demand is the active and waiting slots across the pool (the
  ForwardPassMetrics stream) plus the prefill-queue backlog; a worker's
  capacity is its concurrency at SLO times a utilization headroom,
  derated by the live roofline fraction from the perf plane when a
  worker runs below the model's expectation. SLO pressure
  (``runtime/slo.py`` ``pressure()``) overrides: a burning fleet adds
  capacity even when the slot arithmetic says it fits.
- **FleetScaler** applies the role reconfigurator's guard rails to the
  worker COUNT: hysteresis, a cooldown between actions, at most one
  action in flight fleet-wide, and min/max floors. A scale-out promotes
  a pre-warmed standby (``llm/standby.py``) by an epoch-fenced
  ``scale/`` directive on the planner's lease, or asks the connector
  for a cold worker when no standby waits. A scale-in retires the
  least-loaded serving worker; it drains through the role-flip
  machinery with typed ``incomplete:scale_in`` frames.

Epochs are minted above everything visible in the fleet (role statuses,
pending role and scale directives), so a scale directive racing a flip
shares one fence. Every decision journals as ``planner_decision``, its
cause the latest ``slo_alert_fire`` when pressure drove it, and the
directive carries the decision's ref.

Metrics: ``dynamo_tpu_autoscale_*``. Knobs: ``DTPU_PLANNER_CAPACITY_<FIELD>``
over ``CapacityConfig``.
"""

from __future__ import annotations

import dataclasses
import math
import time

from dynamo_tpu_torch.llm.reconfig import ROLE_ROOT, ROLE_STATUS_ROOT, RoleState
from dynamo_tpu_torch.llm.standby import SCALE_ROOT, STANDBY_ROOT, scale_key
from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.capacity")


@dataclasses.dataclass
class CapacityConfig:
    """Autoscaling knobs. All plain scalars so the generic
    ``DTPU_PLANNER_CAPACITY_<FIELD>`` env override applies
    (runtime/config.py ``_apply_scalar_env``)."""

    enabled: bool = False
    # The role promoted standbys serve / scale-in retires from, and the
    # connector component backfilling the standby pool.
    role: str = "decode"
    component: str = "gpu"
    min_workers: int = 1
    max_workers: int = 8
    # Per-worker concurrency at SLO (the admission cap's kind of number;
    # mockers are configured).
    slots_per_worker: int = 16
    # Headroom: plan to this fraction of the cap, not to saturation.
    target_utilization: float = 0.75
    # Guard rails (RoleReconfigurator discipline).
    hysteresis_intervals: int = 2
    cooldown_s: float = 60.0
    # SLO pressure level at/above which capacity is added regardless of
    # the slot math (burn means the slot math is wrong).
    pressure_level: int = 2
    # Prefill-queue backlog that counts as unserved demand.
    queue_depth_high: int = 8
    # Sustained utilization below this argues for scale-in.
    util_low: float = 0.30
    # Roofline derate: a worker measurably below the expected fraction
    # serves proportionally fewer slots at SLO; never derate below this
    # floor (a cold perf plane must not halve the fleet's capacity).
    derate_floor: float = 0.5
    # Drain budget on retire directives; 0 = worker default.
    drain_s: float = 0.0
    # A pending directive older than this is stuck: reap + replace.
    stuck_scale_s: float = 120.0


def apply_capacity_env(cfg: CapacityConfig) -> CapacityConfig:
    """Overlay DTPU_PLANNER_CAPACITY_* env vars onto ``cfg``."""
    from dynamo_tpu_torch.runtime.config import _apply_scalar_env
    _apply_scalar_env("PLANNER_CAPACITY", cfg)
    return cfg


class CapacityModel:
    """Demand -> target worker count, with an EWMA so one noisy
    interval never moves capacity (the hysteresis above it handles the
    rest)."""

    def __init__(self, cfg: CapacityConfig, alpha: float = 0.5):
        self.cfg = cfg
        self.alpha = alpha
        self._demand_ewma: float | None = None

    def observe(self, active: int, waiting: int, queue_depth: int | None
                ) -> float:
        """Fold one interval's demand observation (concurrent request
        slots wanted fleet-wide) into the EWMA and return it."""
        demand = float(active + waiting + (queue_depth or 0))
        if self._demand_ewma is None:
            self._demand_ewma = demand
        else:
            self._demand_ewma = (self.alpha * demand
                                 + (1 - self.alpha) * self._demand_ewma)
        return self._demand_ewma

    def worker_capacity(self, roofline_frac: float | None = None,
                        expected_frac: float | None = None) -> float:
        """Effective concurrent slots one worker serves at SLO: the
        admission cap times headroom, derated by live-vs-expected
        roofline when the perf plane says this fleet runs slow."""
        cfg = self.cfg
        cap = cfg.slots_per_worker * cfg.target_utilization
        if roofline_frac and expected_frac and expected_frac > 0:
            cap *= min(1.0, max(cfg.derate_floor,
                                roofline_frac / expected_frac))
        return max(1e-9, cap)

    def target(self, current: int, pressure_level: int | None,
               queue_depth: int | None,
               roofline_frac: float | None = None,
               expected_frac: float | None = None) -> int:
        """The worker count the fleet should run, before guard rails."""
        cfg = self.cfg
        demand = self._demand_ewma or 0.0
        want = math.ceil(demand / self.worker_capacity(
            roofline_frac, expected_frac))
        if pressure_level is not None and pressure_level >= \
                cfg.pressure_level:
            # The SLO plane is burning: whatever the slot math says,
            # the fleet needs more capacity NOW.
            want = max(want, current + 1)
        if queue_depth is not None and queue_depth >= cfg.queue_depth_high:
            want = max(want, current + 1)
        return max(cfg.min_workers, min(cfg.max_workers, want))

    @property
    def demand(self) -> float:
        return self._demand_ewma or 0.0


class FleetScaler:
    """One planner's worker-count decision loop (the autoscaler).

    ``pressure_fn``/``queue_depth_fn``/``demand_fn``/``perf_fn`` are
    injectable signal sources (the planner wires defaults; tests
    script them). ``connector`` backfills the standby pool when a
    scale-out finds no warm standby. ``clock`` is injectable so the
    cooldown is fake-clock testable."""

    def __init__(self, client, namespace: str,
                 config: CapacityConfig | None = None,
                 connector=None, pressure_fn=None, queue_depth_fn=None,
                 demand_fn=None, perf_fn=None, clock=time.monotonic,
                 metrics=None):
        self._client = client
        self.namespace = namespace
        self.cfg = config or CapacityConfig()
        self.model = CapacityModel(self.cfg)
        self._connector = connector
        self._pressure_fn = pressure_fn
        self._queue_depth_fn = queue_depth_fn
        self._demand_fn = demand_fn
        self._perf_fn = perf_fn
        self._clock = clock
        self._last_action_t: float | None = None
        self._streak = {"out": 0, "in": 0}
        # Highest epoch this scaler ever saw or minted — kept across
        # directive GC so a reaped orphan's epoch is never re-used
        # (monotonic minting keeps resurrection stories fenceable).
        self._epoch_floor = 0
        self._last_decision_ref: str | None = None
        # Promote directives we issued: worker_hex -> issue monotonic t
        # (join latency is measured when the worker turns up serving).
        self._promotes_inflight: dict[str, float] = {}
        self.issued: list[dict] = []
        self._m_target = self._m_current = self._m_standby = None
        self._m_decisions = self._m_join = None
        if metrics is not None:
            m = metrics.namespace("autoscale")
            self._m_target = m.gauge(
                "autoscale_target_workers",
                "Capacity-model target worker count", ["role"])
            self._m_current = m.gauge(
                "autoscale_current_workers",
                "Serving workers the scaler counts", ["role"])
            self._m_standby = m.gauge(
                "autoscale_standby_pool",
                "Warm standbys available to promote")
            self._m_decisions = m.counter(
                "autoscale_decisions_total",
                "Scaler decisions by action", ["action"])
            self._m_join = m.gauge(
                "autoscale_join_seconds",
                "Last observed promote-to-serving join latency")

    # -- fleet view -----------------------------------------------------------
    async def fleet(self) -> list[dict]:
        items = await self._client.kv_get_prefix(
            f"{ROLE_STATUS_ROOT}{self.namespace}/")
        return [it["v"] for it in items if isinstance(it.get("v"), dict)]

    async def standbys(self) -> list[dict]:
        items = await self._client.kv_get_prefix(
            f"{STANDBY_ROOT}{self.namespace}/")
        return [it["v"] for it in items if isinstance(it.get("v"), dict)]

    async def pending(self) -> list[dict]:
        items = await self._client.kv_get_prefix(
            f"{SCALE_ROOT}{self.namespace}/")
        out = []
        for it in items:
            v = it.get("v")
            if isinstance(v, dict):
                out.append({"key": it["k"], **v})
        return out

    async def role_directives(self) -> list[dict]:
        items = await self._client.kv_get_prefix(
            f"{ROLE_ROOT}{self.namespace}/")
        return [{"key": it["k"], **it["v"]} for it in items
                if isinstance(it.get("v"), dict)]

    # -- one decision step ----------------------------------------------------
    async def step(self) -> dict:
        """Observe, model, guard, maybe issue ONE directive. Returns a
        decision record (``action`` says what happened)."""
        cfg = self.cfg
        pressure = self._pressure_fn() if self._pressure_fn else None
        p_level = pressure.level if pressure is not None else None
        depth = await self._maybe(self._queue_depth_fn)
        demand = await self._maybe(self._demand_fn) or (0, 0)
        perf = await self._maybe(self._perf_fn) or {}
        fleet = await self.fleet()
        standbys = [s for s in await self.standbys()
                    if s.get("state") in ("ready", None)]
        directives = await self.pending()
        directives = await self._gc(fleet, standbys, directives)
        serving = [s for s in fleet
                   if s.get("role") == cfg.role
                   and s.get("state") == RoleState.SERVING]
        current = len(serving)
        self._note_joins(serving)
        self.model.observe(int(demand[0]), int(demand[1]), depth)
        want = self.model.target(
            current, p_level, depth,
            roofline_frac=perf.get("roofline_frac"),
            expected_frac=perf.get("expected_frac"))
        record: dict = {
            "pool": "capacity", "action": "none",
            "pressure": pressure.to_wire() if pressure else None,
            "queue_depth": depth,
            "demand": round(self.model.demand, 2),
            "current": current, "standbys": len(standbys),
            "target": want,
        }
        self._set_gauges(want, current, len(standbys))
        direction = ("out" if want > current
                     else "in" if want < current else None)
        for k in self._streak:
            self._streak[k] = self._streak[k] + 1 if direction == k else 0
        record["signal"] = direction
        record["streaks"] = dict(self._streak)
        if direction is None:
            return record
        if self._streak[direction] < cfg.hysteresis_intervals:
            record["action"] = "hysteresis"
            return self._journal(record)
        now = self._clock()
        if (self._last_action_t is not None
                and now - self._last_action_t < cfg.cooldown_s):
            record["action"] = "cooldown"
            return self._journal(record)
        if self._action_in_flight(fleet, directives):
            record["action"] = "scale_in_flight"
            return self._journal(record)
        if direction == "out":
            return await self._scale_out(record, fleet, standbys,
                                         directives, now)
        return await self._scale_in(record, serving, fleet, directives, now)

    # -- scale-out -------------------------------------------------------------
    async def _scale_out(self, record: dict, fleet, standbys, directives,
                         now: float) -> dict:
        cfg = self.cfg
        if not standbys:
            # No warm standby: ask the substrate for a cold one. The
            # connector is the slow path — it backfills the pool, and a
            # later step promotes the worker once it parks warm.
            record["action"] = "scale_out_cold"
            self._journal(record)
            self._count(record["action"])
            if self._connector is not None:
                total = len(fleet) + len(standbys) + 1
                await self._connector.scale(cfg.component, total)
                record["connector_target"] = total
            self._last_action_t = now
            self._streak["out"] = 0
            return record
        target = standbys[0]
        epoch = self._next_epoch(fleet, directives,
                                 await self.role_directives())
        self._journal(dict(record, action="scale_out",
                           worker=target["worker"], epoch=epoch))
        directive = await self.issue(target["worker"], "promote",
                                     cfg.role, epoch,
                                     cause=self._last_decision_ref)
        self._count("scale_out")
        self._promotes_inflight[target["worker"]] = now
        self._last_action_t = now
        self._streak["out"] = 0
        record["action"] = "scale_out"
        record["directive"] = directive
        return record

    # -- scale-in --------------------------------------------------------------
    async def _scale_in(self, record: dict, serving, fleet, directives,
                        now: float) -> dict:
        cfg = self.cfg
        if len(serving) <= cfg.min_workers:
            record["action"] = "bounded"
            return self._journal(record)
        # Least-loaded serving worker drains fastest; never take the
        # last prefill-capable worker out of a disagg fleet.
        candidates = sorted(serving,
                            key=lambda s: int(s.get("inflight") or 0))
        victim = None
        for s in candidates:
            if s.get("role") in ("prefill", "agg"):
                others = [o for o in fleet if o is not s
                          and o.get("role") in ("prefill", "agg")]
                if not others:
                    continue
            victim = s
            break
        if victim is None:
            record["action"] = "bounded"
            return self._journal(record)
        epoch = self._next_epoch(fleet, directives,
                                 await self.role_directives())
        self._journal(dict(record, action="scale_in",
                           worker=victim["worker"], epoch=epoch))
        directive = await self.issue(victim["worker"], "retire", None,
                                     epoch, cause=self._last_decision_ref)
        self._count("scale_in")
        self._last_action_t = now
        self._streak["in"] = 0
        record["action"] = "scale_in"
        record["directive"] = directive
        return record

    async def issue(self, worker_hex: str, action: str, role: str | None,
                    epoch: int, issued_by: str = "planner",
                    cause: str | None = None) -> dict:
        """Write one scale directive on OUR lease (planner death ->
        lease expiry -> directive gone -> stale scale fenced)."""
        directive = {"action": action, "epoch": int(epoch),
                     "issued_by": issued_by, "ts": time.time()}
        if role is not None:
            directive["role"] = role
        if cause is not None:
            directive["cause"] = cause
        if action == "retire" and self.cfg.drain_s > 0:
            directive["drain_s"] = self.cfg.drain_s
        await self._client.kv_put(
            scale_key(self.namespace, int(worker_hex, 16)), directive,
            use_primary_lease=True)
        self.issued.append({"worker": worker_hex, **directive})
        log.info("issued %s -> %s (epoch %d)", action, worker_hex, epoch)
        return {"worker": worker_hex, **directive}

    # -- internals -------------------------------------------------------------
    @staticmethod
    async def _maybe(fn):
        if fn is None:
            return None
        try:
            res = fn()
            if hasattr(res, "__await__"):
                res = await res
            return res
        except (ConnectionError, OSError, RuntimeError):
            return None

    def _journal(self, record: dict) -> dict:
        """Every decision — including suppressed ones — lands on the
        decision plane. A pressure-driven scale-out names the most
        recent SLO page as its cause, closing the chain the timeline
        walks."""
        cause = None
        if record.get("action") in ("scale_out", "scale_out_cold"):
            cause = journal.recent_ref(EventKind.SLO_ALERT_FIRE)
        # NB ``worker=`` is emit()'s origin override — the TARGET worker
        # rides as a plain attr so the decision stays attributed to the
        # planner and its ref can't collide with the worker's own seqs.
        self._last_decision_ref = journal.emit(
            EventKind.PLANNER_DECISION, cause=cause,
            action=record.get("action"), signal=record.get("signal"),
            pressure=record.get("pressure"),
            queue_depth=record.get("queue_depth"),
            demand=record.get("demand"), current=record.get("current"),
            target=record.get("target"), standbys=record.get("standbys"),
            target_worker=record.get("worker"), epoch=record.get("epoch"))
        return record

    def _count(self, action: str) -> None:
        if self._m_decisions is not None:
            self._m_decisions.inc(action=action)

    def _set_gauges(self, want: int, current: int, standbys: int) -> None:
        if self._m_target is not None:
            self._m_target.set(want, role=self.cfg.role)
            self._m_current.set(current, role=self.cfg.role)
            self._m_standby.set(standbys)

    def _note_joins(self, serving: list[dict]) -> None:
        """A promoted worker turned up serving: record its join
        latency and clear the in-flight marker."""
        for s in serving:
            t0 = self._promotes_inflight.pop(s.get("worker"), None)
            if t0 is not None and self._m_join is not None:
                self._m_join.set(self._clock() - t0)

    def _action_in_flight(self, fleet: list[dict],
                          directives: list[dict]) -> bool:
        """At most one scale action in flight fleet-wide: any pending
        scale directive, any draining worker, or an unjoined promote."""
        cfg = self.cfg
        now = time.time()
        for s in fleet:
            if s.get("state") == RoleState.DRAINING:
                return True
        for d in directives:
            age = now - float(d.get("ts") or now)
            if cfg.stuck_scale_s > 0 and age > cfg.stuck_scale_s:
                log.warning("ignoring stuck scale directive %s (%.0fs old)",
                            d.get("key"), age)
                continue
            return True
        return False

    def _next_epoch(self, fleet: list[dict], scale_directives: list[dict],
                    role_directives: list[dict]) -> int:
        """Strictly above EVERY epoch visible in the fleet — including
        pending role-flip directives, so a scale directive racing a
        flip shares one fence and exactly one side applies."""
        top = self._epoch_floor
        for s in fleet:
            top = max(top, int(s.get("epoch") or 0))
        for d in scale_directives + role_directives:
            top = max(top, int(d.get("epoch") or 0))
        self._epoch_floor = top + 1
        return top + 1

    async def _gc(self, fleet: list[dict], standbys: list[dict],
                  directives: list[dict]) -> list[dict]:
        """Reap applied/orphaned scale directives (same contract as the
        reconfigurator's GC: a directive is a pending verb, not desired
        state). An orphaned PROMOTE — its standby died mid-join (no
        standby key, no rolestatus) — journals so the replacement
        promotion is attributable."""
        by_worker = {s.get("worker"): s for s in fleet}
        standby_ids = {s.get("worker") for s in standbys}
        keep = []
        for d in directives:
            self._epoch_floor = max(self._epoch_floor,
                                    int(d.get("epoch") or 0))
            worker = d["key"].rsplit("/", 1)[-1]
            status = by_worker.get(worker)
            applied = (status is not None
                       and int(status.get("epoch") or 0)
                       >= int(d.get("epoch") or 0))
            orphaned = (d.get("action") == "promote"
                        and status is None
                        and worker not in standby_ids)
            retired_gone = d.get("action") == "retire" and status is None
            if applied or orphaned or retired_gone:
                if orphaned:
                    self._last_decision_ref = journal.emit(
                        EventKind.PLANNER_DECISION,
                        cause=d.get("cause"),
                        action="promote_orphaned", worker=worker,
                        epoch=d.get("epoch"))
                    self._count("promote_orphaned")
                    # The join died with the standby: clear the fence
                    # so the replacement promotion isn't counted as an
                    # action already in flight.
                    self._promotes_inflight.pop(worker, None)
                    self._last_action_t = None
                try:
                    await self._client.kv_delete(d["key"])
                except (ConnectionError, OSError, RuntimeError):
                    pass
                continue
            keep.append(d)
        return keep
