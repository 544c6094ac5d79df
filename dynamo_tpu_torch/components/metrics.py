"""Metrics aggregator component (copy of ``dynamo_tpu.components.metrics``
on the port's asyncio HTTP server instead of aiohttp).

It subscribes to the workers' ForwardPassMetrics subjects of one or more
components and serves the fleet view as Prometheus gauges, per worker
and summed, on ``/metrics``: the scrape target of dashboards and the
planner's operators.

    python -m dynamo_tpu_torch.components.metrics --components gpu,prefill --port 9091

It prints ``METRICS_AGGREGATOR_READY port=N`` (``--port 0`` picks one)
and exits 0 on SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.llm.kv_router.protocols import (ForwardPassMetrics,
                                                load_metrics_subject)
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.http_server import (Exchange, HttpServer,
                                                  Request)
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.metrics import CONTENT_TYPE

log = get_logger("metrics_aggregator")


class MetricsAggregator:
    def __init__(self, runtime, namespace: str, components: list[str],
                 stale_s: float = 30.0):
        self._runtime = runtime
        self.namespace = namespace
        self.components = components
        self.stale_s = stale_s
        self._subs: list = []
        self._tasks: list[asyncio.Task] = []
        # (component, worker) -> (last_update_monotonic, metrics)
        self._last: dict[tuple[str, str], tuple[float, ForwardPassMetrics]] \
            = {}
        m = runtime.metrics.namespace(namespace)
        self._g_fleet_active = m.gauge(
            "fleet_active_slots", "Active slots across live workers",
            ["component"])
        self._g_fleet_waiting = m.gauge(
            "fleet_waiting_requests", "Queued requests across live workers",
            ["component"])
        self._g_fleet_workers = m.gauge(
            "fleet_live_workers", "Workers reporting within the staleness "
            "window", ["component"])
        self._g_active = m.gauge(
            "worker_active_slots", "Active request slots per worker",
            ["component", "worker"])
        self._g_waiting = m.gauge(
            "worker_waiting_requests", "Queued requests per worker",
            ["component", "worker"])
        self._g_kv = m.gauge(
            "worker_kv_usage", "KV pool usage fraction per worker",
            ["component", "worker"])
        self._g_hit = m.gauge(
            "worker_prefix_hit_rate", "Prefix cache hit rate per worker",
            ["component", "worker"])

    async def start(self) -> None:
        client = self._runtime.require_coordinator()
        for comp in self.components:
            sub = await client.subscribe(
                load_metrics_subject(self.namespace, comp))
            self._subs.append(sub)
            self._tasks.append(asyncio.create_task(self._intake(comp, sub)))
        self._tasks.append(asyncio.create_task(self._reap_loop()))

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for s in self._subs:
            await s.cancel()

    async def _intake(self, comp: str, sub) -> None:
        async for msg in sub:
            try:
                m = ForwardPassMetrics.from_wire(msg["payload"])
            except (KeyError, TypeError, ValueError):
                continue
            worker = f"{m.worker_id or 0:x}"
            self._last[(comp, worker)] = (asyncio.get_running_loop().time(),
                                          m)
            ws, ks = m.worker_stats, m.kv_stats
            self._g_active.set(ws.request_active_slots, component=comp,
                               worker=worker)
            self._g_waiting.set(ws.num_requests_waiting, component=comp,
                                worker=worker)
            self._g_kv.set(ks.gpu_cache_usage_perc, component=comp,
                           worker=worker)
            self._g_hit.set(ks.gpu_prefix_cache_hit_rate, component=comp,
                            worker=worker)
            self._refresh_fleet()

    def _refresh_fleet(self) -> None:
        """Fleet totals over non-stale workers; stale workers' per-worker
        series are zeroed so a dead worker's last load doesn't haunt
        dashboards forever."""
        now = asyncio.get_running_loop().time()
        totals: dict[str, list[int]] = {c: [0, 0, 0] for c in self.components}
        for (comp, worker), (t, m) in list(self._last.items()):
            if now - t > self.stale_s:
                self._g_active.set(0, component=comp, worker=worker)
                self._g_waiting.set(0, component=comp, worker=worker)
                self._g_kv.set(0, component=comp, worker=worker)
                self._g_hit.set(0, component=comp, worker=worker)
                del self._last[(comp, worker)]
                continue
            tot = totals.setdefault(comp, [0, 0, 0])
            tot[0] += m.worker_stats.request_active_slots
            tot[1] += m.worker_stats.num_requests_waiting
            tot[2] += 1
        for comp, (active, waiting, n) in totals.items():
            self._g_fleet_active.set(active, component=comp)
            self._g_fleet_waiting.set(waiting, component=comp)
            self._g_fleet_workers.set(n, component=comp)

    async def _reap_loop(self) -> None:
        while True:
            await asyncio.sleep(max(1.0, self.stale_s / 3))
            self._refresh_fleet()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo_tpu_torch metrics aggregator")
    p.add_argument("--namespace", default=None)
    p.add_argument("--components", default="gpu",
                   help="comma-separated worker components to aggregate")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9091)
    p.add_argument("--coordinator-url", default=None)
    return p.parse_args(argv)


async def run(args) -> None:
    cfg = RuntimeConfig.from_settings()
    if args.coordinator_url:
        cfg.coordinator_url = args.coordinator_url
    if args.namespace:
        cfg.namespace = args.namespace
    runtime = await DistributedRuntime.from_settings(cfg)
    agg = MetricsAggregator(runtime, cfg.namespace,
                            [c.strip() for c in args.components.split(",")
                             if c.strip()])
    await agg.start()

    async def metrics_route(_req: Request, ex: Exchange) -> None:
        await ex.send(200, CONTENT_TYPE, runtime.metrics.expose())

    server = HttpServer(args.host, args.port)
    server.add("GET", "/metrics", metrics_route)
    await server.start()
    print(f"METRICS_AGGREGATOR_READY port={server.port}", flush=True)
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, runtime.shutdown)
    try:
        await runtime.wait_for_shutdown()
    finally:
        await agg.stop()
        await server.stop()
        await runtime.close()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
