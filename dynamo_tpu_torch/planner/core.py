"""The planner's loop (copy of ``dynamo_tpu.planner.core``).

It consumes the workers' ForwardPassMetrics stream (the pub/sub plane
the KV router reads), aggregates each pool's load, predicts one
adjustment interval ahead and asks the connector for replica counts:

- decode pool: replicas sized so the predicted concurrent requests fit
  the per-worker slots at a utilization headroom;
- prefill pool (disaggregated deployments): replicas sized from the
  predicted prefill tokens against the per-worker capacity
  (``profiler.choose_capacity``).

Guard rails: min/max replicas, scale-down hysteresis. With
``reconfig.enabled`` it also drives live prefill/decode role flips from
the SLO plane's pressure and the prefill queue's depth
(``planner/reconfig.py``), and with ``capacity.enabled`` it owns the
worker count through standby promotions and retirements
(``planner/capacity.py``). Each step's records are in ``decisions``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import time

from dynamo_tpu_torch.llm.kv_router.protocols import (ForwardPassMetrics,
                                                load_metrics_subject)
from dynamo_tpu_torch.planner.capacity import CapacityConfig, FleetScaler
from dynamo_tpu_torch.planner.connector import Connector
from dynamo_tpu_torch.planner.predictors import make_predictor
from dynamo_tpu_torch.planner.reconfig import ReconfigConfig, RoleReconfigurator
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner")


@dataclasses.dataclass
class PlannerConfig:
    namespace: str = "dynamo"
    decode_component: str = "gpu"
    prefill_component: str | None = None  # None = aggregated deployment
    adjustment_interval_s: float = 10.0
    predictor: str = "moving_average"
    predictor_window: int = 6
    # Decode sizing.
    max_num_seqs_per_worker: int = 32
    target_utilization: float = 0.8  # headroom before scaling up
    # Prefill sizing (tokens/s one worker sustains within the TTFT SLA;
    # normally filled from profiler.choose_capacity).
    prefill_capacity_tok_s: float = 8000.0
    min_replicas: int = 1
    max_replicas: int = 8
    # Consecutive under-loaded intervals required before scaling down.
    scale_down_patience: int = 3
    # Served model name: enables the prefill-queue depth signal for role
    # reconfiguration (queue_name(model_name) on the coordinator).
    model_name: str | None = None
    # Live role-flip decisions (planner/reconfig.py); knobs overridable
    # via DTPU_PLANNER_RECONFIG_<FIELD>.
    reconfig: ReconfigConfig = dataclasses.field(
        default_factory=ReconfigConfig)
    # SLA-driven autoscaling (planner/capacity.py); knobs overridable
    # via DTPU_PLANNER_CAPACITY_<FIELD>. When enabled it OWNS worker
    # count for its role — the legacy per-pool replica deciders stand
    # down so two loops never fight over the same StatefulSet.
    capacity: CapacityConfig = dataclasses.field(
        default_factory=CapacityConfig)


class PoolState:
    """Aggregated view of one worker pool from its metrics stream."""

    def __init__(self, predictor: str, window: int):
        self.workers: dict[int, ForwardPassMetrics] = {}
        self.last_seen: dict[int, float] = {}
        self.load_pred = make_predictor(predictor, window=window)
        self.tok_pred = make_predictor(predictor, window=window)

    def observe(self, worker_id: int, metrics: ForwardPassMetrics) -> None:
        self.workers[worker_id] = metrics
        self.last_seen[worker_id] = time.monotonic()

    def snapshot(self, stale_s: float = 30.0) -> dict:
        now = time.monotonic()
        live = {w: m for w, m in self.workers.items()
                if now - self.last_seen.get(w, 0) < stale_s}
        active = sum(m.worker_stats.request_active_slots for m in live.values())
        waiting = sum(m.worker_stats.num_requests_waiting for m in live.values())
        return {"workers": len(live), "active": active, "waiting": waiting,
                "live": live}


class Planner:
    def __init__(self, config: PlannerConfig, connector: Connector,
                 runtime=None):
        self.config = config
        self.connector = connector
        self._runtime = runtime
        self.decode = PoolState(config.predictor, config.predictor_window)
        self.prefill = (PoolState(config.predictor, config.predictor_window)
                        if config.prefill_component else None)
        self._below: dict[str, int] = {"decode": 0, "prefill": 0}
        self._subs: list = []
        self._tasks: list[asyncio.Task] = []
        self.decisions: list[dict] = []
        # Role-flip loop: constructed in start() (needs the coordinator),
        # or injected directly by tests / embedded deployments.
        self.reconfigurator: RoleReconfigurator | None = None
        # Autoscaler (planner/capacity.py): same injection contract.
        self.scaler: FleetScaler | None = None

    # -- metrics intake -------------------------------------------------------
    async def start(self) -> None:
        """Subscribe to the pools' metrics subjects (needs a runtime)."""
        assert self._runtime is not None
        client = self._runtime.require_coordinator()
        cfg = self.config
        pools = [(cfg.decode_component, self.decode)]
        if self.prefill is not None:
            pools.append((cfg.prefill_component, self.prefill))
        for comp, pool in pools:
            sub = await client.subscribe(
                load_metrics_subject(cfg.namespace, comp))
            self._subs.append(sub)
            self._tasks.append(asyncio.create_task(self._intake(sub, pool)))
        if cfg.reconfig.enabled and self.reconfigurator is None:
            self.reconfigurator = RoleReconfigurator(
                client, cfg.namespace, cfg.reconfig,
                pressure_fn=self._slo_pressure,
                queue_depth_fn=(self._queue_depth
                                if cfg.model_name else None))
        if cfg.capacity.enabled and self.scaler is None:
            self.scaler = FleetScaler(
                client, cfg.namespace, cfg.capacity,
                connector=self.connector,
                pressure_fn=self._slo_pressure,
                queue_depth_fn=(self._queue_depth
                                if cfg.model_name else None),
                demand_fn=self._demand,
                metrics=getattr(self._runtime, "metrics", None))
        # The planner's decisions (and their input signals) ride the
        # journal subject into the frontend's merged /debug/timeline, as
        # the workers' journals do.
        from dynamo_tpu_torch.runtime.journal import JournalPublisher, get_journal
        get_journal().worker = "planner"
        self._journal_pub = JournalPublisher(client, cfg.namespace, "planner")
        self._journal_pub.start_periodic()
        self._tasks.append(asyncio.create_task(self._loop()))

    @staticmethod
    def _slo_pressure():
        """Default pressure source: the process-global SLO plane (level 0
        when no targets are configured — reconfig then rides the queue
        signal alone)."""
        from dynamo_tpu_torch.runtime import slo
        plane = slo.get_plane()
        return plane.pressure() if plane.enabled else None

    async def _queue_depth(self) -> int:
        from dynamo_tpu_torch.llm.prefill_queue import queue_name
        client = self._runtime.require_coordinator()
        return await client.queue_len(queue_name(self.config.model_name))

    def _demand(self) -> tuple[int, int]:
        """Capacity-model demand source: (active, waiting) slots across
        the decode pool's live metrics stream."""
        snap = self.decode.snapshot()
        return snap["active"], snap["waiting"]

    async def stop(self) -> None:
        pub = getattr(self, "_journal_pub", None)
        if pub is not None:
            pub.stop_periodic()
        for t in self._tasks:
            t.cancel()
        for s in self._subs:
            await s.cancel()

    async def _intake(self, sub, pool: PoolState) -> None:
        async for msg in sub:
            payload = msg["payload"]
            try:
                m = ForwardPassMetrics.from_wire(payload)
                pool.observe(m.worker_id or 0, m)
            except (KeyError, TypeError, ValueError):
                log.warning("malformed metrics payload: %r", payload)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.adjustment_interval_s)
            try:
                await self.step()
            except Exception:  # noqa: BLE001
                log.exception("planner step failed")

    # -- decisions ------------------------------------------------------------
    def _bounded(self, n: int) -> int:
        return max(self.config.min_replicas,
                   min(self.config.max_replicas, n))

    async def _decide(self, pool_name: str, component: str, snap: dict,
                      demand: float, predictor, capacity: float) -> dict:
        """Shared observe -> predict -> bound -> hysteresis -> scale step
        for one pool."""
        cfg = self.config
        predictor.observe(demand)
        predicted = predictor.predict()
        want = self._bounded(math.ceil(predicted / max(1e-9, capacity)))
        current = await self.connector.current(component)
        if current is None:
            current = snap["workers"] or cfg.min_replicas
        decide = current
        if want > current:
            decide = want
            self._below[pool_name] = 0
        elif want < current:
            # Hysteresis: only shrink after sustained low demand.
            self._below[pool_name] += 1
            if self._below[pool_name] >= cfg.scale_down_patience:
                decide = want
                self._below[pool_name] = 0
        else:
            self._below[pool_name] = 0
        record = {"pool": pool_name, "demand": demand,
                  "predicted": predicted, "current": current,
                  "target": decide}
        if decide != current:
            await self.connector.scale(component, decide)
        self.decisions.append(record)
        return record

    async def step(self) -> dict:
        """One adjustment: observe, predict, decide, scale per pool.
        Returns the decision records (also appended to self.decisions)."""
        cfg = self.config
        capacity_record = None
        if self.scaler is not None and cfg.capacity.enabled:
            try:
                capacity_record = await self.scaler.step()
                self.decisions.append(capacity_record)
            except (ConnectionError, OSError, RuntimeError):
                # The rest of the step must survive a flaky control
                # plane; the next interval retries.
                log.warning("capacity scaler step failed", exc_info=True)
        reconfig_record = None
        if self.reconfigurator is not None and self.config.reconfig.enabled:
            try:
                reconfig_record = await self.reconfigurator.step()
                self.decisions.append(reconfig_record)
            except (ConnectionError, OSError, RuntimeError):
                log.warning("role reconfig step failed", exc_info=True)
        if self.scaler is not None and cfg.capacity.enabled:
            # The autoscaler owns worker count: the legacy per-pool
            # replica deciders stand down (two loops patching the same
            # StatefulSet would fight).
            out = {"capacity": capacity_record}
            if reconfig_record is not None:
                out["reconfig"] = reconfig_record
            return out
        snap = self.decode.snapshot()
        record = await self._decide(
            "decode", cfg.decode_component, snap,
            snap["active"] + snap["waiting"], self.decode.load_pred,
            cfg.max_num_seqs_per_worker * cfg.target_utilization)
        if self.prefill is None:
            out = {"decode": record}
            if reconfig_record is not None:
                out["reconfig"] = reconfig_record
            return out
        psnap = self.prefill.snapshot()
        # Prefill demand proxy: queued-request pressure (LIVE workers only
        # — dead workers' last metrics must not inflate demand forever)
        # times a nominal prompt length, against profiled throughput.
        ptok = sum((m.worker_stats.num_requests_waiting or 0)
                   for m in psnap["live"].values()) * 512.0
        precord = await self._decide(
            "prefill", cfg.prefill_component, psnap, ptok,
            self.prefill.tok_pred, cfg.prefill_capacity_tok_s)
        out = {"decode": record, "prefill": precord}
        if reconfig_record is not None:
            out["reconfig"] = reconfig_record
        return out
