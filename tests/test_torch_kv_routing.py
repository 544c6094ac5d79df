"""KV-cache-aware routing end to end over the port's coordinator on
127.0.0.1, with tiny-test engines on the CPU.

- The reference's three scenarios of
  ``tests/test_router_e2e_with_mockers.py`` on port workers (GPUEngine
  with its three publishers) behind the port front under ``--router-mode
  kv``: a repeated prefix sticks to the worker that holds it;
  ``--busy-threshold`` answers 503 ``overloaded`` with ``Retry-After``;
  two router replicas share their in-flight load through router_sync.
- Mixed fleets: the JAX front in kv mode routes a repeated prefix to the
  port worker that holds it, and the port front in kv mode does the same
  over JAX workers (``TPUEngine`` with the JAX publishers).
- A port and a JAX ``KvPushRouter``, fed the same recorded events and
  metrics over stub clients, pick the same worker for every request.
- A worker whose lease expires leaves the router's index at once
  (``note_worker_leave`` from discovery's delete), not after the prune
  loop's ticks.
"""

import asyncio
import http.client
import json
import time
import types

import jax
import numpy as np
import pytest
import torch
from conftest import async_test
from test_torch_engine import ENGINE_KW, SPEC_J, SPEC_T

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm import kv_router as jkr
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm.http_service import HttpService as JHttpService
from dynamo_tpu.llm.kv_router import publisher as jpub
from dynamo_tpu.llm.kv_router import protocols as jproto
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.llm import kv_router as tkr
from dynamo_tpu_torch.llm.kv_router import protocols as tproto
from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import distributed as tdist
from dynamo_tpu_torch.runtime.context import Context as TContext

torch.set_num_threads(1)

MODEL = "tiny-test"
# The lease-expiry test's TTL: a lost worker leaves within a few of these.
LEASE_TTL_S = 1.0
# Every other test's TTL. Their workers, fronts and coordinator share one
# event loop with CPU engines, and under a loaded machine keepalives every
# LEASE_TTL_S / 3 can arrive late: the coordinator then expires a live
# worker's lease, the router drops that worker's blocks from its index (as
# it must for a lost worker), and a later decision sees no overlap.
STEADY_LEASE_TTL_S = 10.0
PREFIX = np.random.default_rng(5).integers(0, SPEC_T.vocab_size,
                                           64).tolist()


def _ids(seed, n):
    return np.random.default_rng(seed).integers(0, SPEC_T.vocab_size,
                                                n).tolist()


def _http(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), json.loads(
            resp.read())
    finally:
        conn.close()


async def complete(port, prompt, max_tokens=4):
    status, _, body = await asyncio.to_thread(
        _http, port, "/v1/completions",
        {"model": MODEL, "prompt": prompt, "max_tokens": max_tokens,
         "ignore_eos": True})
    assert status == 200, body
    assert body["usage"]["completion_tokens"] == max_tokens
    return body


async def wait_for(predicate, timeout=20.0):
    t0 = time.monotonic()
    while not predicate():
        assert time.monotonic() - t0 < timeout, "condition never held"
        await asyncio.sleep(0.02)


def port_engine(**kw) -> GPUEngine:
    """Unstarted: the worker starts it on its loop, which its publishers
    use."""
    return GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       **dict(ENGINE_KW, **kw)), seed=0)


async def start_port_worker(url, engine, lease_ttl_s=STEADY_LEASE_TTL_S):
    """A worker as ``backends.gpu`` builds one: the three publishers on
    its instance id, the engine started on this loop, the inventory's
    periodic republish, the handler served and the model registered."""
    rt = await tdist.DistributedRuntime.from_settings(
        tconfig.RuntimeConfig(coordinator_url=url, lease_ttl_s=lease_ttl_s))
    kv_pub, metrics_pub, inv_pub = gpu.make_publishers(rt)
    metrics_pub.min_interval_s = 0.01
    engine.kv_publisher, engine.metrics_publisher = kv_pub, metrics_pub
    engine.inventory_publisher = inv_pub
    engine.start()
    inv_pub.start_periodic(engine.inventory_digest)
    server = await gpu.serve_engine(rt, engine, MODEL, make_test_tokenizer())

    async def stop():
        inv_pub.stop_periodic()
        engine.stop()
        try:
            await server.shutdown(drain_s=0)
        finally:
            await rt.close()
    return types.SimpleNamespace(rt=rt, engine=engine, server=server,
                                 stop=stop, id=rt.instance_id)


async def start_port_front(url, lease_ttl_s=STEADY_LEASE_TTL_S,
                           **factory_kw):
    rt = await tdist.DistributedRuntime.from_settings(
        tconfig.RuntimeConfig(coordinator_url=url, lease_ttl_s=lease_ttl_s))
    service, watcher = await launch.start_front(
        rt, "127.0.0.1", 0, "kv", tkr.make_kv_router_factory(**factory_kw))

    async def stop():
        await service.stop()
        await watcher.stop()
        await rt.close()
    return types.SimpleNamespace(rt=rt, service=service, watcher=watcher,
                                 port=service.port, stop=stop)


async def served_router(front, n_workers):
    await wait_for(lambda: front.watcher.manager.get(MODEL) is not None)
    served = front.watcher.manager.get(MODEL)
    await wait_for(lambda: len(served.client.instance_ids()) == n_workers)
    return served.router


def _rows(router) -> list:
    """(worker, chosen overlap, best overlap, blocks) per decision, from
    the DecisionLog's ring (both packages keep them there)."""
    return list(router.decisions._ring)


async def _sticks(port, router, lagging_metrics=False):
    """Send the prefix once, wait until the router's index holds its
    blocks, then four more prompts that open with it: every decision goes
    to the worker that served the first, with the whole prefix matched.

    ``lagging_metrics``: JAX workers publish their last load metrics
    before releasing the pages of the requests that just finished, so an
    idle holder reports them as active; on 64-token prompts that outweighs
    the prefix's 4 blocks, and the reference's cost sends the first
    repeat to the other worker, which then holds the prefix too. Then
    every decision after the first repeat matches the whole prefix."""
    await complete(port, PREFIX + _ids(100, 9))
    first = _rows(router)[-1][0]
    await wait_for(lambda: router.indexer.tree.num_blocks
                   >= len(PREFIX) // 16)
    for i in range(4):
        await complete(port, PREFIX + _ids(200 + i, 7 + i))
    rows = _rows(router)[-4:]
    full = len(PREFIX) // 16
    assert all(r[2] == full for r in rows), rows
    if lagging_metrics:
        assert all(r[1] == full for r in rows[1:]), rows
    else:
        assert [r[0] for r in rows] == [first] * 4, rows
        assert all(r[1] == full for r in rows), rows
    return first


@async_test(timeout=120)
async def test_repeated_prefix_sticks_to_one_worker():
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    workers = [await start_port_worker(coord.url, port_engine())
               for _ in range(2)]
    front = await start_port_front(coord.url)
    try:
        router = await served_router(front, 2)
        first = await _sticks(front.port, router)
        holder = next(w for w in workers if w.id == first)
        assert holder.engine.prefix_hit_blocks >= 4 * len(PREFIX) // 16
        # The holder's load metrics and both workers' digests (the idle
        # one's from its periodic republish) reached the router.
        await wait_for(lambda: first in router.scheduler.metrics
                       and router.fleet.workers() >= {w.id for w in workers},
                       timeout=10)
        # A port worker publishes after the deferred release: gone idle,
        # it reports no active pages.
        assert router.scheduler.metrics[first].kv_stats.kv_active_blocks == 0
        status = router.kv_status()
        assert status["outcomes"]["suboptimal"] == 0
        assert status["federation_sources"]["radix"] >= 4
        assert status["fleet"]["workers"][f"{first:x}"]["blocks"] > 0
    finally:
        await front.stop()
        for w in workers:
            await w.stop()
        await coord.stop()


@async_test(timeout=120)
async def test_busy_threshold_answers_503():
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    # A 23-page pool and slowed windows, so a 190-token prompt holds over
    # half the pool while its decode runs.
    engine = port_engine(num_pages=24)
    inner = engine._dispatch_window

    def slow_window():
        time.sleep(0.1)
        return inner()

    engine._dispatch_window = slow_window
    worker = await start_port_worker(coord.url, engine)
    front = await start_port_front(coord.url, busy_threshold=0.5)
    try:
        router = await served_router(front, 1)
        hog = asyncio.create_task(complete(front.port, _ids(7, 190), 60))

        def busy():
            m = router.scheduler.metrics.get(worker.id)
            return m is not None and router.scheduler._usage(worker.id) >= 0.5
        await wait_for(busy)
        status, retry_after, body = await asyncio.to_thread(
            _http, front.port, "/v1/completions",
            {"model": MODEL, "prompt": _ids(8, 20), "max_tokens": 4})
        assert status == 503, body
        assert body["error"]["type"] == "overloaded"
        assert "busy threshold" in body["error"]["message"]
        assert int(retry_after) >= 1
        await hog
    finally:
        await front.stop()
        await worker.stop()
        await coord.stop()


@async_test(timeout=120)
async def test_two_router_replicas_share_load_state():
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    engine = port_engine()
    inner = engine._dispatch_window

    def slow_window():
        time.sleep(0.05)
        return inner()

    engine._dispatch_window = slow_window
    worker = await start_port_worker(coord.url, engine)
    f1 = await start_port_front(coord.url)
    f2 = await start_port_front(coord.url)
    try:
        await served_router(f1, 1)
        r2 = await served_router(f2, 1)
        slow = asyncio.create_task(complete(f1.port, _ids(9, 100), 40))
        await wait_for(lambda: r2.sequences.active_seqs(worker.id) > 0)
        await slow
        await wait_for(lambda: r2.sequences.active_seqs(worker.id) == 0)
        assert r2.sequences.active_blocks(worker.id) == 0
    finally:
        await f1.stop()
        await f2.stop()
        await worker.stop()
        await coord.stop()


@async_test(timeout=120)
async def test_jax_front_routes_to_the_port_worker_holding_the_prefix():
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    workers = [await start_port_worker(coord.url, port_engine())
               for _ in range(2)]
    rt = await jdist.DistributedRuntime.from_settings(jconfig.RuntimeConfig(
        coordinator_url=coord.url, lease_ttl_s=STEADY_LEASE_TTL_S))
    manager = jdisc.ModelManager()
    watcher = jdisc.ModelWatcher(
        rt, manager, router_mode="kv",
        kv_router_factory=jkr.make_kv_router_factory())
    await watcher.start()
    service = JHttpService(rt, manager, host="127.0.0.1", port=0)
    await service.start()
    try:
        await wait_for(lambda: manager.get(MODEL) is not None)
        served = manager.get(MODEL)
        await wait_for(lambda: len(served.client.instance_ids()) == 2)
        first = await _sticks(service.port, served.router)
        holder = next(w for w in workers if w.id == first)
        assert holder.engine.prefix_hit_blocks >= 4 * len(PREFIX) // 16
        await wait_for(lambda: served.router.fleet.workers()
                       >= {w.id for w in workers}, timeout=10)
    finally:
        await service.stop()
        await watcher.stop()
        for w in workers:
            await w.stop()
        await rt.close()
        await coord.stop()


async def start_jax_worker(url, jparams):
    rt = await jdist.DistributedRuntime.from_settings(jconfig.RuntimeConfig(
        coordinator_url=url, lease_ttl_s=STEADY_LEASE_TTL_S))
    ns = rt.config.namespace
    kv_pub = jpub.KvEventPublisher(rt, ns, "tpu", rt.instance_id)
    m_pub = jpub.WorkerMetricsPublisher(rt, ns, "tpu", rt.instance_id,
                                        min_interval_s=0.01)
    inv_pub = jpub.KvInventoryPublisher(rt, ns, "tpu", rt.instance_id)
    engine = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                         **ENGINE_KW), params=jparams,
                       kv_publisher=kv_pub, metrics_publisher=m_pub)
    engine.inventory_publisher = inv_pub
    engine.start()
    inv_pub.start_periodic(engine.inventory_digest)
    ep = rt.namespace(ns).component("tpu").endpoint("generate")
    server = await ep.serve_endpoint(engine.handler(),
                                     graceful_shutdown=False)
    await jcard.register_llm(rt, ep, MODEL, j_test_tokenizer(),
                             context_length=256, kv_cache_block_size=16)

    async def stop():
        inv_pub.stop_periodic()
        await server.shutdown()
        engine.stop()
        await rt.close()
    return types.SimpleNamespace(rt=rt, engine=engine, stop=stop,
                                 id=rt.instance_id)


@async_test(timeout=180)
async def test_port_front_routes_to_the_jax_worker_holding_the_prefix():
    jparams = jmodel.init_params(SPEC_J, jax.random.key(44))
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    workers = [await start_jax_worker(coord.url, jparams) for _ in range(2)]
    front = await start_port_front(coord.url)
    try:
        router = await served_router(front, 2)
        await _sticks(front.port, router, lagging_metrics=True)
        assert sum(w.engine.prefix_hit_blocks for w in workers) >= \
            3 * len(PREFIX) // 16
        await wait_for(lambda: set(router.scheduler.metrics)
                       >= {w.id for w in workers}
                       and router.fleet.workers() >= {w.id for w in workers},
                       timeout=10)
    finally:
        await front.stop()
        for w in workers:
            await w.stop()
        await coord.stop()


def test_overloaded_error_crosses_the_wire():
    """A worker's ``overloaded: `` error frame (the JAX package's prefix)
    reads back as OverloadedError, which the front answers with 503."""
    from dynamo_tpu.runtime.errors import OverloadedError as JOverloaded
    from dynamo_tpu_torch.runtime.errors import (OverloadedError,
                                                 error_from_wire)
    assert OverloadedError.WIRE_PREFIX == JOverloaded.WIRE_PREFIX
    exc = error_from_wire(f"{JOverloaded.WIRE_PREFIX}queue full")
    assert type(exc) is OverloadedError and str(exc) == "queue full"
    assert exc.retry_after_s is None


class _StubCoordinator:
    def __init__(self):
        self.published = []

    async def publish(self, subject, payload):
        self.published.append((subject, dict(payload)))


class _StubClient:
    """Endpoint client stand-in: the candidate ids, and per request one
    output item, then the stream waits until released."""

    def __init__(self, ids):
        self.ids = list(ids)
        self.routed = []
        self.release: dict[str, asyncio.Event] = {}

    def instance_ids(self):
        return list(self.ids)

    async def generate(self, request, context=None, instance_id=None):
        self.routed.append(instance_id)
        gate = self.release.setdefault(context.id, asyncio.Event())

        async def stream():
            yield {"token_ids": [1]}
            await gate.wait()
            yield {"token_ids": [2], "finish_reason": "length"}
        return stream()

    async def close(self):
        pass


@pytest.mark.parametrize("seed", range(4))
@async_test(timeout=60)
async def test_port_and_jax_routers_pick_the_same_workers(seed):
    rng = np.random.default_rng(seed)
    ids = [int(w) for w in rng.choice(2**40, 3, replace=False)]
    prefixes = [_ids(1000 * seed + i, 16 * int(rng.integers(2, 9)))
                for i in range(4)]
    fed = {}
    for name, kr, proto, ctx_cls in (
            ("port", tkr, tproto, TContext), ("jax", jkr, jproto, JContext)):
        coord = _StubCoordinator()
        rt = types.SimpleNamespace(require_coordinator=lambda c=coord: c,
                                   metrics=MetricsRegistry())
        client = _StubClient(ids)
        router = kr.KvPushRouter(rt, "dynamo", "gpu", client,
                                 kr.KvRouterConfig(federation=bool(seed % 2)))
        fed[name] = (router, client, proto, ctx_cls)
    ev_rng = np.random.default_rng(seed + 50)
    streams = {name: [] for name in fed}
    for i in range(24):
        # Recorded traffic of the event plane between two requests.
        w = ids[ev_rng.integers(3)]
        p = prefixes[ev_rng.integers(4)]
        n = int(ev_rng.integers(1, len(p) // 16 + 1))
        hashes = compute_block_hashes(p, 16)[:n]
        kind = "stored" if ev_rng.random() < 0.8 else "removed"
        total = int(ev_rng.integers(64, 512))
        active = int(ev_rng.integers(0, total))
        seq_no = i + 1
        for name, (router, client, proto, _) in fed.items():
            router.indexer.apply(proto.RouterEvent(
                worker_id=w, event=getattr(proto.KvCacheEvent, kind)(hashes)))
            router.scheduler.update_metrics(proto.ForwardPassMetrics(
                worker_id=w, kv_stats=proto.KvStats(
                    kv_active_blocks=active, kv_total_blocks=total)))
            router.fleet.apply(proto.KvInventoryDigest(
                worker_id=w, seq=seq_no,
                sketch=proto.kmin_sketch(compute_block_hashes(p, 16)[:n])))
        prompt = prefixes[ev_rng.integers(4)] + _ids(i, int(ev_rng.integers(
            1, 40)))
        rid = f"req-{seed}-{i}"
        for name, (router, client, _, ctx_cls) in fed.items():
            req = {"model": MODEL, "token_ids": prompt,
                   "stop_conditions": {"max_tokens": 2}}
            agen = router.generate(req, ctx_cls(rid)).__aiter__()
            assert (await agen.__anext__())["token_ids"] == [1]
            streams[name].append((rid, agen, client))
        # Finish some in-flight requests (the ledger's free).
        for name in fed:
            keep = []
            for j, (r, agen, client) in enumerate(streams[name]):
                if (j + i) % 3 == 0:
                    client.release[r].set()
                    assert [x async for x in agen][-1]["finish_reason"] == \
                        "length"
                else:
                    keep.append((r, agen, client))
            streams[name] = keep
    port_routed = fed["port"][1].routed
    assert port_routed == fed["jax"][1].routed
    assert len(set(port_routed)) > 1
    assert fed["port"][0].decisions.snapshot() == \
        fed["jax"][0].decisions.snapshot()
    # The router_sync payloads are the same dicts, replica ids aside.
    sync = {name: [(s, {k: v for k, v in p.items() if k != "replica"})
                   for s, p in router._runtime.require_coordinator().published]
            for name, (router, _, _, _) in fed.items()}
    assert sync["port"] == sync["jax"]


@async_test(timeout=60)
async def test_lease_expiry_drops_the_worker_from_the_index_at_once():
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    workers = [await start_port_worker(coord.url, port_engine(),
                                       lease_ttl_s=LEASE_TTL_S)
               for _ in range(2)]
    front = await start_port_front(coord.url, lease_ttl_s=LEASE_TTL_S)
    try:
        router = await served_router(front, 2)
        await complete(front.port, PREFIX + _ids(3, 5))
        holder_id = _rows(router)[-1][0]
        await wait_for(lambda: holder_id in router.indexer.tree.workers()
                       and holder_id in router.fleet.workers())
        holder = next(w for w in workers if w.id == holder_id)
        # Lost without deregistering: the coordinator expires its lease
        # and discovery's delete reaches the router.
        router._tasks[-1].cancel()  # no prune loop: only the delete acts
        holder.rt.require_coordinator()._keepalive_task.cancel()
        holder.engine.stop()
        t0 = time.monotonic()
        await wait_for(lambda: holder_id not in router.indexer.tree.workers(),
                       timeout=10)
        assert holder_id not in router.fleet.workers()
        assert holder_id not in router.scheduler.metrics
        assert time.monotonic() - t0 < 5 * LEASE_TTL_S
        # The request that follows goes to the live worker.
        await complete(front.port, PREFIX + _ids(4, 5))
        assert _rows(router)[-1][0] != holder_id
    finally:
        await front.stop()
        for w in workers:
            try:
                await w.stop()
            except Exception:  # noqa: BLE001 — the expired one's runtime
                pass
        await coord.stop()
