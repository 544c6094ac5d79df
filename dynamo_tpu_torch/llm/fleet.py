"""Fleet KV/capacity pane: fan out over every worker's status server
(copy of ``dynamo_tpu.llm.fleet`` on the port's stdlib HTTP client).

Workers that run a ``SystemStatusServer`` register its address under
``system/<namespace>/<instance_hex>`` on the coordinator (lease-bound, so
a dead worker's entry expires with its lease). The frontend's ``GET
/debug/fleet`` reads that prefix and fans out ``GET /debug/kv`` (and
``GET /debug/perf``) to every worker with bounded concurrency and a
per-worker timeout; an unreachable worker contributes ``{"ok": false,
"error": ...}`` instead of failing the pane.
"""

from __future__ import annotations

import asyncio
import time

from dynamo_tpu_torch.runtime.http_server import http_get_json
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("fleet")

SYSTEM_ROOT = "system/"

#: Fan-out bounds: the pane is an operator/doctor surface, not a hot
#: path — small concurrency keeps a big fleet's probe from spiking the
#: frontend, the timeout keeps one blackholed worker from stalling it.
DEFAULT_TIMEOUT_S = 2.0
DEFAULT_CONCURRENCY = 8


def system_status_key(namespace: str, instance_id: int) -> str:
    return f"{SYSTEM_ROOT}{namespace}/{instance_id:x}"


async def register_status_server(runtime, port: int,
                                 extra: dict | None = None) -> None:
    """Advertise this worker's status server for the fleet pane. Rides
    the primary lease: deregistration is automatic on death, and a lease
    the coordinator had to grant anew gets the entry again."""
    coordinator = runtime.require_coordinator()
    addr = f"{runtime.advertise_host}:{port}"
    key = system_status_key(runtime.config.namespace, runtime.instance_id)
    value = {"addr": addr, **(extra or {})}

    async def put(lease_id: int) -> None:
        await coordinator.kv_put(key, value, lease_id=lease_id)

    await put(coordinator.primary_lease_id)
    coordinator.on_lease_recreated(put)
    log.info("status server advertised at %s for the fleet pane", addr)


async def _probe_worker(sem: asyncio.Semaphore, worker: str, info: dict,
                        timeout_s: float) -> tuple[str, dict]:
    addr = info.get("addr")
    base = {"addr": addr, **{k: v for k, v in info.items() if k != "addr"}}
    if not addr:
        return worker, {"ok": False, "error": "no status address "
                        "registered", **base}
    async with sem:
        try:
            status, kv = await http_get_json(addr, "/debug/kv", timeout_s)
            if status != 200:
                return worker, {"ok": False,
                                "error": f"HTTP {status}", **base}
            res = {"ok": True, "kv": kv, **base}
        except (OSError, ValueError, asyncio.TimeoutError) as exc:
            return worker, {"ok": False,
                            "error": f"{type(exc).__name__}: {exc}", **base}
        # Perf view: same status server, typed partial result. A worker
        # predating the perf plane answers 404 (a port worker 501);
        # neither contributes a "perf" body.
        try:
            status, perf = await http_get_json(addr, "/debug/perf",
                                               timeout_s)
            if status == 200:
                res["perf"] = perf
            elif status not in (404, 501):
                res["perf"] = {"error": f"HTTP {status}"}
        except (OSError, ValueError, asyncio.TimeoutError) as exc:
            res["perf"] = {"error": f"{type(exc).__name__}: {exc}"}
    return worker, res


def _aggregate(workers: dict[str, dict]) -> dict:
    """Fleet totals over the reachable workers' allocator/tier stats."""
    agg = {"workers_ok": 0, "workers_down": 0, "pages_total": 0,
           "pages_free": 0, "pages_active": 0, "cached_blocks": 0,
           "tier_blocks": {}, "reuse_hit_blocks": 0,
           "reuse_lookup_blocks": 0, "unexpected_recompiles": 0,
           "compiles_total": 0}
    for res in workers.values():
        if not res.get("ok"):
            agg["workers_down"] += 1
            continue
        agg["workers_ok"] += 1
        compiles = (res.get("perf") or {}).get("compiles") or {}
        agg["unexpected_recompiles"] += compiles.get(
            "unexpected_recompiles_total", 0)
        agg["compiles_total"] += compiles.get("compiles_total", 0)
        kv = res.get("kv") or {}
        alloc = kv.get("allocator") or {}
        agg["pages_total"] += alloc.get("pages_total", 0)
        agg["pages_free"] += alloc.get("pages_free", 0)
        agg["pages_active"] += alloc.get("pages_active", 0)
        agg["cached_blocks"] += alloc.get("cached_blocks", 0)
        agg["reuse_hit_blocks"] += alloc.get("reuse_hit_blocks", 0)
        agg["reuse_lookup_blocks"] += alloc.get("reuse_lookup_blocks", 0)
        for tier, n in ((kv.get("digest") or {}).get("tier_blocks")
                        or {}).items():
            agg["tier_blocks"][tier] = agg["tier_blocks"].get(tier, 0) + n
    agg["occupancy"] = (agg["pages_active"] / agg["pages_total"]
                        if agg["pages_total"] else 0.0)
    agg["hit_rate"] = (agg["reuse_hit_blocks"] / agg["reuse_lookup_blocks"]
                       if agg["reuse_lookup_blocks"] else 0.0)
    return agg


async def fleet_kv_snapshot(runtime, namespace: str | None = None,
                            timeout_s: float = DEFAULT_TIMEOUT_S,
                            concurrency: int = DEFAULT_CONCURRENCY,
                            router_view=None) -> dict:
    """The /debug/fleet body. ``router_view`` is the optional local KV
    router's kv_status() callable — merged in so one GET answers both
    "what does each worker hold" and "how cache-aware is routing"."""
    ns = namespace or runtime.config.namespace
    t0 = time.monotonic()
    try:
        items = await runtime.require_coordinator().kv_get_prefix(
            f"{SYSTEM_ROOT}{ns}/")
    except (ConnectionError, OSError, RuntimeError) as exc:
        return {"namespace": ns, "error": f"discovery unavailable: {exc}",
                "workers": {}, "partial": True}
    registered = {item["k"].rsplit("/", 1)[-1]: item["v"]
                  for item in items if isinstance(item.get("v"), dict)}
    sem = asyncio.Semaphore(max(1, concurrency))
    workers: dict[str, dict] = {}
    if registered:
        results = await asyncio.gather(*(
            _probe_worker(sem, worker, info, timeout_s)
            for worker, info in sorted(registered.items())))
        workers = dict(results)
    errors = sum(1 for r in workers.values() if not r.get("ok"))
    out = {
        "namespace": ns,
        "workers": workers,
        "partial": errors > 0,
        "errors": errors,
        "aggregate": _aggregate(workers),
        "probe_seconds": round(time.monotonic() - t0, 4),
    }
    if router_view is not None:
        try:
            out["router"] = router_view()
        except Exception as exc:  # noqa: BLE001 — pane stays partial
            out["router"] = {"error": str(exc)}
    return out
