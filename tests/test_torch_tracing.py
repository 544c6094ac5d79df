"""The port's spans (``dynamo_tpu_torch.runtime.tracing``) against the JAX
package's: the same span calls under a pinned clock and pinned ids give
equal Chrome and OTLP exports, indexes and span payloads; the disabled
recorder allocates nothing; ``capture_profile`` on ``torch.profiler``
answers with the reference's keys, refuses a second capture, and never
degrades to a span dump where CUDA was asked for; GPUEngine's
engine-thread spans and phase histograms; and the end-to-end trace of
``tests/test_tracing.py`` (HTTP front -> router -> worker over the real
request plane) over a port frontend and port worker and over both mixed
pairings, with ``/debug/traces`` read back over HTTP."""

import asyncio
import itertools
import json
import os
import time
import tracemalloc
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from conftest import async_test
from test_torch_engine import ENGINE_KW, SPEC_J, SPEC_T
from test_torch_http import call
from test_torch_preprocessor import MODEL
from test_torch_worker import (LEASE_TTL_S, port_engine, start_jax_front,
                               start_port_front, start_port_worker,
                               wait_for)

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu.runtime import tracing as jtr
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import tracing as ttr
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.logging import make_traceparent
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

TRACE_ID = "1234567890abcdef1234567890abcdef"
PARENT_ID = "feedfacecafebeef"


@pytest.fixture(autouse=True)
def _fresh_recorders():
    saved = []
    for mod in (jtr, ttr):
        rec = mod.get_recorder()
        saved.append(rec.enabled)
        rec.clear()
        rec.enabled = True
    yield
    for mod, was in zip((jtr, ttr), saved):
        mod.get_recorder().enabled = was
        mod.get_recorder().clear()


class _Clock:
    """A pinned clock: each read steps 1 ms (monotonic) from fixed
    origins."""

    def __init__(self):
        self._mono = itertools.count(1000)
        self._wall = itertools.count(1_700_000_000_000)

    def monotonic(self):
        return next(self._mono) / 1000.0

    def time(self):
        return next(self._wall) / 1000.0


def _pin(monkeypatch, mod):
    """Pin ``mod``'s clock and id generators."""
    monkeypatch.setattr(mod, "time", _Clock())
    spans = itertools.count(1)
    traces = itertools.count(1)
    monkeypatch.setattr(mod, "generate_span_id",
                        lambda: f"{next(spans):016x}")
    monkeypatch.setattr(mod, "generate_trace_id",
                        lambda: f"{next(traces):032x}")


def _spans_of(mod) -> dict:
    """One scenario of span calls on a fresh recorder of ``mod``: every
    exporter's output."""
    rec = mod.SpanRecorder(capacity=64)
    ctx = SimpleNamespace(trace_id=TRACE_ID, span_id="00000000000000aa",
                          parent_span_id=PARENT_ID)
    with mod.span("http.request", ctx=ctx, recorder=rec, route="chat",
                  ok=True, n=3, frac=0.5):
        with mod.span("router.decide", recorder=rec, mode="kv") as sp:
            sp.set(worker_id="7", overlap_blocks=2)
        with pytest.raises(ValueError):
            with mod.span("worker.request", ctx=ctx, recorder=rec):
                raise ValueError("boom")
        t0 = mod.time.monotonic()
        rec.add("engine.decode", ctx.trace_id, ctx.span_id, t0,
                mod.time.monotonic(), attrs={"tokens": 8, "window": 8})

    async def cancelled():
        async with mod.span("kv.transfer.recv", recorder=rec):
            await asyncio.sleep(10)

    async def run():
        task = asyncio.ensure_future(cancelled())
        await asyncio.sleep(0)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        async with mod.span("root.other", recorder=rec, x="y"):
            pass

    asyncio.run(run())
    return {
        "chrome_all": rec.export_chrome(),
        "chrome_trace": rec.export_chrome(TRACE_ID),
        "otlp_all": rec.export_otlp(),
        "otlp_trace": rec.export_otlp(TRACE_ID),
        "index": mod.traces_index(rec, limit=10),
        "spans": mod.trace_payload(TRACE_ID, "spans", recorder=rec),
        "otlp_payload": mod.trace_payload(TRACE_ID, "otlp", recorder=rec),
        "unknown": mod.trace_payload("ff" * 16, recorder=rec),
    }


def test_exports_equal_the_reference_under_a_pinned_clock(monkeypatch):
    _pin(monkeypatch, jtr)
    _pin(monkeypatch, ttr)
    ref, got = _spans_of(jtr), _spans_of(ttr)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(ref))
    names = [e["name"] for e in got["chrome_trace"]["traceEvents"]]
    assert names == ["http.request", "router.decide", "worker.request",
                     "engine.decode"]
    statuses = {e["name"]: e["args"].get("status")
                for e in got["chrome_all"]["traceEvents"]}
    assert statuses["worker.request"] == "error"
    assert statuses["kv.transfer.recv"] == "cancelled"


def test_bad_trace_format_is_refused_like_the_reference():
    for mod in (jtr, ttr):
        with mod.span("x") as sp:
            pass
        trace_id = mod.get_recorder()._snapshot()[0].trace_id
        with pytest.raises(ValueError, match="unknown trace format"):
            mod.trace_payload(trace_id, "xml")
        del sp


def test_ring_counts_what_it_drops():
    rec = ttr.SpanRecorder(capacity=4)
    for i in range(10):
        with ttr.span(f"s{i}", recorder=rec):
            pass
    assert len(rec._snapshot()) == 4 and rec.dropped == 6
    assert ttr.traces_index(rec)["dropped"] == 6


@async_test(timeout=30)
async def test_span_parenting_across_tasks():
    async def child():
        async with ttr.span("child"):
            await asyncio.sleep(0)

    async with ttr.span("parent") as p:
        await asyncio.gather(child(), child())
    spans = ttr.get_recorder()._snapshot()
    parent = next(s for s in spans if s.name == "parent")
    kids = [s for s in spans if s.name == "child"]
    assert p is not None and len(kids) == 2
    assert all(k.parent_span_id == parent.span_id
               and k.trace_id == parent.trace_id for k in kids)


def test_span_adopts_a_request_context():
    ctx = Context(trace_id=TRACE_ID, parent_span_id=PARENT_ID)
    with ttr.span("worker.request", ctx=ctx):
        with ttr.span("inner", ctx=ctx):
            pass
    outer, inner = sorted(ttr.get_recorder().trace(TRACE_ID),
                          key=lambda s: s.name != "worker.request")
    assert (outer.span_id, outer.parent_span_id) == (ctx.span_id,
                                                     PARENT_ID)
    assert inner.parent_span_id == ctx.span_id != inner.span_id


def test_disabled_recorder_is_a_noop_singleton():
    rec = ttr.get_recorder()
    ttr.set_enabled(False)
    assert ttr.span("a") is ttr.NULL_SPAN is ttr.span("b", tokens=8)
    with ttr.span("x") as sp:
        sp.set(a=1)
    assert rec.add("x", "ab" * 16, None, 0.0, 1.0) is None
    assert rec._snapshot() == []


def test_disabled_recorder_zero_allocations():
    """The per-token fast path allocates nothing with tracing off."""
    rec = ttr.get_recorder()
    rec.enabled = False
    trace_id = "ab" * 16

    def hot_loop(n):
        for _ in range(n):
            if rec.enabled:
                rec.add("engine.decode", trace_id, None, 0.0, 1.0)
            with ttr.span("engine.window"):
                pass

    hot_loop(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        hot_loop(5000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    stats = [s for s in after.compare_to(before, "filename")
             if "tracing.py" in (s.traceback[0].filename or "")]
    assert sum(s.size_diff for s in stats) <= 0, stats


# -- the profiler capture ------------------------------------------------------

@async_test(timeout=60)
async def test_capture_profile_has_the_reference_keys(tmp_path):
    with ttr.span("before.capture"):
        pass
    out = await ttr.capture_profile(50, str(tmp_path), cuda=False)
    assert out["mode"] == "torch"
    assert {"mode", "out_dir", "span_dump", "duration_ms",
            "wall_s"} <= set(out)
    assert out["kernels"] == {}  # no CUDA activity on the CPU
    with open(out["trace"]) as fh:
        assert "traceEvents" in json.load(fh)
    assert out["trace_bytes"] == os.path.getsize(out["trace"])
    with open(out["span_dump"]) as fh:
        dump = json.load(fh)
    assert any(e["name"] == "before.capture" for e in dump["traceEvents"])


def test_trace_events_decode_one_at_a_time_like_json(tmp_path):
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (torch.randn(64) + 1).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    text = path.read_text()
    assert list(ttr._trace_events(text)) == json.loads(text)["traceEvents"]


def test_prepare_profiler_runs_an_empty_session():
    assert ttr.prepare_profiler() >= 0.0


@async_test(timeout=60)
async def test_capture_runs_the_hook_before_each_blocking_step(tmp_path):
    calls = []

    async def renew():
        calls.append(time.monotonic())

    async def broken():
        raise ConnectionError("coordinator away")
    out = await ttr.capture_profile(20, str(tmp_path / "a"), cuda=False,
                                    before_block=renew)
    assert out["mode"] == "torch" and len(calls) == 2
    # A failing hook is logged; the capture goes on.
    out = await ttr.capture_profile(20, str(tmp_path / "b"), cuda=False,
                                    before_block=broken)
    assert out["mode"] == "torch"


@async_test(timeout=60)
async def test_a_second_capture_at_once_is_refused(tmp_path):
    first = asyncio.ensure_future(
        ttr.capture_profile(400, str(tmp_path / "a"), cuda=False))
    await asyncio.sleep(0.05)
    with pytest.raises(ttr.ProfileBusyError):
        await ttr.capture_profile(10, str(tmp_path / "b"), cuda=False)
    assert (await first)["mode"] == "torch"


@async_test(timeout=60)
async def test_cuda_capture_fails_instead_of_degrading(tmp_path, monkeypatch):
    """Where CUDA activity was asked for, a profiler that records none is
    an error (HTTP 500), never the reference's span-dump fallback."""
    from dynamo_tpu_torch.engine.runner import CAPTURE_LOCK
    # A session waits for a CUDA graph capture under way, and holds the
    # capture lock until it stops.
    CAPTURE_LOCK.acquire()
    asyncio.get_running_loop().call_later(0.3, CAPTURE_LOCK.release)
    t0 = time.monotonic()
    with pytest.raises(ttr.ProfileError, match="no CUDA kernel"):
        await ttr.capture_profile(20, str(tmp_path), cuda=True)
    assert time.monotonic() - t0 >= 0.3
    assert not CAPTURE_LOCK.locked()

    async def broken(*a, **k):
        raise RuntimeError("profiler already claimed")
    monkeypatch.setattr(ttr, "_torch_profile", broken)
    with pytest.raises(ttr.ProfileError, match="already claimed"):
        await ttr.capture_profile(20, str(tmp_path), cuda=True)
    # A CPU-only process degrades as the reference does.
    out = await ttr.capture_profile(20, str(tmp_path), cuda=False)
    assert out["mode"] == "spans"


# -- the engine's spans and phase histograms ---------------------------------

@async_test(timeout=240)
async def test_engine_spans_and_phase_histograms_match_the_reference():
    """The same requests through TPUEngine and GPUEngine with a registry
    each: every request's trace holds engine.queue_wait, engine.prefill
    and engine.decode, the decode spans carry every token but the first,
    queue-wait counts equal, and decode_step_seconds counts the windows
    each engine processed."""
    jparams = jmodel.init_params(SPEC_J, jax.random.key(7))
    from dynamo_tpu.runtime.context import Context as JContext
    from dynamo_tpu.runtime.metrics import MetricsRegistry as JRegistry
    from dynamo_tpu_torch.engine.weights import params_from_jax
    jreg, treg = JRegistry(), MetricsRegistry()
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW), params=jparams,
                     metrics_registry=jreg.namespace("ns").component("c"))
    teng = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       **ENGINE_KW),
                     params=params_from_jax(
                         jax.tree.map(np.asarray, jparams), SPEC_T,
                         device="cpu"),
                     metrics_registry=treg.namespace("ns").component("c"))
    teng.start()
    rng = np.random.default_rng(3)
    reqs = [{"model": MODEL, "token_ids": rng.integers(
                0, SPEC_T.vocab_size, n).tolist(),
             "stop_conditions": {"max_tokens": 12, "ignore_eos": True}}
            for n in (5, 17, 30)]

    async def run(engine, mod, ctx_cls):
        ctxs = [ctx_cls() for _ in reqs]

        async def one(req, ctx):
            out = []
            async for item in engine.generate(req, ctx):
                out.extend(item.get("token_ids", []))
            return out
        toks = await asyncio.gather(*[one(r, c) for r, c in zip(reqs, ctxs)])
        rec = mod.get_recorder()
        for ctx, t in zip(ctxs, toks):
            spans = rec.trace(ctx.trace_id)
            names = {s.name for s in spans}
            assert {"engine.queue_wait", "engine.prefill",
                    "engine.decode"} <= names, names
            assert sum(s.attrs["tokens"] for s in spans
                       if s.name == "engine.decode") == len(t) - 1
        return engine.phase

    try:
        jphase = await run(jeng, jtr, JContext)
        tphase = await run(teng, ttr, Context)
    finally:
        jeng.stop()
        teng.stop()
    assert tphase.queue_wait.get().count == jphase.queue_wait.get().count \
        == len(reqs)
    assert tphase.decode.get().count == teng.step_count > 0
    assert 1 <= tphase.prefill.get().count <= len(reqs)
    expo = treg.expose().decode()
    for name in ("prefill_chunk_tokens_total", "prefill_chunks_inflight",
                 "decode_stall_seconds", "kv_pages", "kv_occupancy"):
        assert f"dynamo_tpu_{name}" in expo, name


# -- the end-to-end distributed trace ----------------------------------------

async def _jax_worker(url):
    jparams = jmodel.init_params(SPEC_J, jax.random.key(44))
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW), params=jparams)
    rt = await jdist.DistributedRuntime.from_settings(
        jconfig.RuntimeConfig(coordinator_url=url, lease_ttl_s=LEASE_TTL_S))
    ep = rt.namespace("dynamo").component("tpu").endpoint("generate")
    server = await ep.serve_endpoint(jeng.handler(), graceful_shutdown=False)
    await jcard.register_llm(rt, ep, MODEL, j_test_tokenizer(),
                             context_length=256)
    return rt, server, jeng


@pytest.mark.parametrize("front,worker", [("port", "port"), ("jax", "port"),
                                          ("port", "jax")])
@async_test(timeout=180)
async def test_e2e_trace_crosses_front_and_worker(front, worker):
    """A chat with an external traceparent: http.request (parented to the
    caller) and router.decide on the front's recorder, worker.request
    (parented to http.request) and the engine's spans on the worker's,
    one trace id; the port front serves the trace back over HTTP."""
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    engine = None
    if worker == "port":
        engine = port_engine()
        w_rt, server = await start_port_worker(coord.url, engine)
    else:
        w_rt, server, engine = await _jax_worker(coord.url)
    start = start_port_front if front == "port" else start_jax_front
    f_rt, service, watcher = await start(coord.url)
    front_rec = (ttr if front == "port" else jtr).get_recorder()
    worker_rec = (ttr if worker == "port" else jtr).get_recorder()
    try:
        await wait_for(lambda: watcher.manager.get(MODEL) is not None)
        header = make_traceparent(TRACE_ID, PARENT_ID)
        body = {"model": MODEL, "max_tokens": 4, "ignore_eos": True,
                "messages": [{"role": "user", "content": "trace me"}]}
        import http.client

        def post():
            conn = http.client.HTTPConnection("127.0.0.1", service.port,
                                              timeout=60)
            try:
                conn.request("POST", "/v1/chat/completions",
                             body=json.dumps(body).encode(),
                             headers={"Content-Type": "application/json",
                                      "traceparent": header})
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()
        status, raw = await asyncio.to_thread(post)
        assert status == 200, raw
        want_front = {"http.request", "router.decide"}
        want_worker = {"worker.request", "engine.queue_wait",
                       "engine.prefill", "engine.decode"}
        await wait_for(lambda: want_front <= {
            s.name for s in front_rec.trace(TRACE_ID)} and want_worker <= {
            s.name for s in worker_rec.trace(TRACE_ID)}, timeout=20)
        http_span = next(s for s in front_rec.trace(TRACE_ID)
                         if s.name == "http.request")
        assert http_span.parent_span_id == PARENT_ID
        worker_span = next(s for s in worker_rec.trace(TRACE_ID)
                           if s.name == "worker.request")
        assert worker_span.parent_span_id == http_span.span_id
        status, _, raw = await call(service.port, "GET",
                                    "/debug/traces/recent")
        assert status == 200
        assert any(t["trace_id"] == TRACE_ID
                   for t in json.loads(raw)["traces"])
        status, _, raw = await call(
            service.port, "GET",
            f"/debug/traces?trace_id={TRACE_ID}&format=chrome")
        assert status == 200
        events = json.loads(raw)["traceEvents"]
        assert want_front <= {e["name"] for e in events}
        assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
        status, _, raw = await call(service.port, "GET",
                                    f"/debug/traces?trace_id={'ee' * 16}")
        assert status == 404 and b"not found" in raw
    finally:
        await service.stop()
        await watcher.stop()
        await server.shutdown()
        engine.stop()
        await f_rt.close()
        await w_rt.close()
        await coord.stop()
