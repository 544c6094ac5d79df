"""The port's system status server and debug API
(``dynamo_tpu_torch.runtime.health``), its fleet pane (``llm/fleet.py``),
``/v1/responses`` and TLS on the HTTP front, held against the JAX
package's on the CPU:

- a worker's status server answers ``/health``, ``/live``, ``/metrics``
  and every debug route, ``/debug/slo`` and ``/debug/perf`` (the engine's
  ``perf_status``) included; the control verbs, served, answer 404
  naming what this server lacks (a role manager, a scale agent);
  ``POST /debug/profile`` answers ``mode: "torch"`` and 409 to a second
  capture at once;
- a JAX front and a port front over the same port worker: ``/debug/*``
  bodies with the reference's keys (``/debug/slo`` and ``/debug/perf``
  too), the same ``/v1/responses`` objects and streamed events, the same
  501s, the fleet pane listing the worker;
- TLS with an ``openssl``-made certificate, as in
  ``tests/test_http_e2e.py``; half-configured TLS fails at start;
- the reference's own ``scripts/trace_view.py`` and
  ``scripts/timeline_view.py``, unmodified, render the port's
  ``/debug/traces``, ``/debug/flight`` and ``/debug/timeline``;
- the frontend's and worker's new flags and settings are served.
"""

import asyncio
import json
import ssl
import subprocess
import sys

import pytest
from conftest import async_test
from test_torch_http import ROOT, call, sse_events
from test_torch_preprocessor import MODEL
from test_torch_engine import ENGINE_KW, SPEC_T
from test_torch_worker import (_port_runtime, start_jax_front,
                               start_port_front, wait_for)

from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.frontend import main as frontend_main
from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
from dynamo_tpu_torch.llm.fleet import register_status_server
from dynamo_tpu_torch.llm.timeline import TimelineCollector
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.health import SystemStatusServer
from dynamo_tpu_torch.runtime.tracing import get_recorder, span


async def _get(port, path, method="GET", body=None):
    status, ctype, raw = await call(port, method, path, body)
    return status, ctype, raw


async def _json(port, path, method="GET", body=None):
    status, _, raw = await call(port, method, path, body)
    return status, json.loads(raw)


async def _worker_fleet():
    """A coordinator, a port worker with its status server registered for
    the fleet pane, and its runtime."""
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    w_rt = await _port_runtime(coord.url)
    engine = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                         **ENGINE_KW), seed=0,
                       metrics_registry=w_rt.metrics.namespace("dynamo")
                       .component("gpu"))
    engine.start()
    server = await gpu.serve_engine(w_rt, engine, MODEL,
                                    make_test_tokenizer())
    status = SystemStatusServer(w_rt, host="127.0.0.1", port=0,
                                kv_provider=engine.kv_status,
                                perf_provider=engine.perf_status)
    await status.start()
    await register_status_server(w_rt, status.port,
                                 extra={"backend": "gpu", "model": MODEL})

    async def stop():
        await status.stop()
        await server.shutdown()
        engine.stop()
        await w_rt.close()
        await coord.stop()
    return coord, engine, w_rt, status, stop


@async_test(timeout=120)
async def test_status_server_routes(tmp_path):
    coord, engine, w_rt, status, stop = await _worker_fleet()
    try:
        port = status.port
        st, body = await _json(port, "/health")
        assert (st, body) == (200, {"status": "healthy", "endpoints": {}})
        assert await _json(port, "/live") == (200, {"status": "live"})
        st, ctype, raw = await _get(port, "/metrics")
        assert st == 200 and ctype.startswith("text/plain")
        text = raw.decode()
        for name in ("requests_total", "kv_pages", "decode_step_seconds"):
            assert f"dynamo_tpu_{name}" in text, name
        st, kv = await _json(port, "/debug/kv")
        assert st == 200 and kv["role"] == "engine"
        assert set(kv) >= {"allocator", "tiers", "reuse", "digest"}
        st, body = await _json(port, "/debug/slo")
        assert st == 200 and set(body) == {
            "enabled", "fast_burn_threshold", "slow_burn_threshold",
            "pages_total", "targets", "pressure"}
        st, body = await _json(port, "/debug/perf")
        assert st == 200 and set(body) == {"role", "compiles", "window",
                                           "roofline", "hbm", "memory"}
        assert body["role"] == "engine" and body["hbm"] == {}
        # The control verbs are served; this server carries no role
        # manager or scale agent, so they answer 404 naming which.
        for path, what in (("/control/role", "role manager"),
                           ("/control/scale", "scale agent")):
            for method in ("GET", "POST"):
                st, body = await _json(port, path, method, {})
                assert st == 404 and body == {
                    "error": f"no {what} on this worker"}
        st, body = await _json(port, "/debug/requests?limit=5")
        assert st == 200 and set(body) == {"capacity", "total", "counts",
                                           "sink", "records"}
        st, body = await _json(port, "/debug/flight")
        assert st == 200 and set(body) == {"meta", "windows",
                                           "triggers_total"}
        st, body = await _json(port, "/debug/flight", "POST",
                               {"out_dir": str(tmp_path), "reason": "probe"})
        assert st == 200 and body["reason"] == "probe"
        with open(body["bundle"]) as fh:
            assert json.load(fh)["reason"] == "probe"
        st, body = await _json(port, "/debug/timeline?limit=3")
        assert st == 200 and body["role"] == "process"
        assert (await _json(port, "/debug/timeline?limit=x"))[0] == 400
        with span("status.probe"):
            pass
        st, body = await _json(port, "/debug/traces/recent")
        assert st == 200 and set(body) == {"enabled", "capacity", "dropped",
                                           "traces"}
        tid = body["traces"][0]["trace_id"]
        st, body = await _json(port, f"/debug/traces?trace_id={tid}"
                                     "&format=otlp")
        assert st == 200 and "resourceSpans" in body
        assert (await _json(port, f"/debug/traces?trace_id={tid}"
                                  "&format=xml"))[0] == 400
        first = asyncio.ensure_future(_json(port, "/debug/profile", "POST", {
            "duration_ms": 600, "out_dir": str(tmp_path / "a")}))
        await asyncio.sleep(0.2)
        st, body = await _json(port, "/debug/profile", "POST", {
            "duration_ms": 10, "out_dir": str(tmp_path / "b")})
        assert st == 409 and "already running" in body["error"]
        st, body = await first
        assert st == 200 and body["mode"] == "torch"
        assert (await _get(port, "/nope"))[0] == 404
    finally:
        await stop()


def _responses_body(stream: bool) -> dict:
    return {"model": MODEL, "input": "the quick brown fox",
            "instructions": "answer", "max_output_tokens": 6,
            "stream": stream}


@async_test(timeout=180)
async def test_fronts_serve_the_same_debug_bodies_and_responses():
    """A JAX front and a port front over the same port worker."""
    coord, engine, w_rt, status, stop = await _worker_fleet()
    fronts = {"jax": await start_jax_front(coord.url),
              "port": await start_port_front(coord.url)}
    try:
        for _, service, watcher in fronts.values():
            await wait_for(lambda w=watcher: w.manager.get(MODEL)
                           is not None)
        out = {}
        for name, (_, service, _) in fronts.items():
            port = service.port
            res = {}
            st, res["responses"] = await _json(port, "/v1/responses",
                                               "POST", _responses_body(False))
            assert st == 200, res["responses"]
            st, ctype, raw = await _get(port, "/v1/responses", "POST",
                                        _responses_body(True))
            assert st == 200 and ctype.startswith("text/event-stream")
            res["stream"] = [block.split("\n", 1)[0] for block in
                             raw.decode().strip().split("\n\n")]
            res["completed"] = json.loads(
                raw.decode().strip().split("\n\n")[-1].split("data: ", 1)[1])
            for path in ("/debug/requests", "/debug/flight",
                         "/debug/traces/recent", "/debug/timeline",
                         "/debug/kv", "/debug/fleet", "/debug/slo",
                         "/debug/perf"):
                st, body = await _json(port, path)
                assert st == 200, (name, path, body)
                res[path] = body
            st, res["clear"] = await _json(port, "/clear_kv_blocks", "POST",
                                           {})
            assert st == 200
            out[name] = res
        j, t = out["jax"], out["port"]
        for key in ("id", "created_at"):
            j["responses"].pop(key)
            t["responses"].pop(key)
            j["completed"]["response"].pop(key)
            t["completed"]["response"].pop(key)
        assert t["responses"] == j["responses"]
        assert t["stream"] == j["stream"]
        assert t["completed"] == j["completed"]
        for path in ("/debug/requests", "/debug/flight",
                     "/debug/traces/recent", "/debug/fleet", "/debug/slo",
                     "/debug/perf"):
            assert set(t[path]) == set(j[path]), path
        rec_t = t["/debug/requests"]["records"][0]
        rec_j = j["/debug/requests"]["records"][0]
        assert set(rec_t) == set(rec_j)
        assert (rec_t["route"], rec_t["status"]) == ("responses", "ok")
        assert set(t["/debug/timeline"]) == set(j["/debug/timeline"])
        assert set(t["/debug/kv"]) >= {"role", "routers", "engines"}
        for pane in (t["/debug/fleet"], j["/debug/fleet"]):
            assert set(pane["workers"]) == {f"{w_rt.instance_id:x}"}
            assert all(w["ok"] for w in pane["workers"].values())
        assert set(t["clear"]["cleared"][MODEL]) == {
            f"{w_rt.instance_id:x}"}
        # /v1/embeddings is served since the embeddings slice: a body
        # without input is a 400, as on the JAX front;
        # /v1/audio/transcriptions still waits for its item.
        for path, item in (("/v1/embeddings", None),
                           ("/v1/audio/transcriptions", "15")):
            st, body = await _json(fronts["port"][1].port, path, "POST",
                                   {"model": MODEL})
            if item is None:
                j_st, j_body = await _json(fronts["jax"][1].port, path,
                                           "POST", {"model": MODEL})
                assert (st, body) == (j_st, j_body) == (400, {"error": {
                    "message": "missing 'input'",
                    "type": "invalid_request_error", "param": None,
                    "code": None}})
                continue
            assert st == 501 and f"ROADMAP item {item}" in \
                body["error"]["message"]
    finally:
        for rt, service, watcher in fronts.values():
            await service.stop()
            await watcher.stop()
            await rt.close()
        await stop()


@async_test(timeout=120)
async def test_front_metrics_count_the_traffic():
    coord, engine, w_rt, status, stop = await _worker_fleet()
    f_rt, service, watcher = await start_port_front(coord.url)
    try:
        await wait_for(lambda: watcher.manager.get(MODEL) is not None)
        body = {"model": MODEL, "max_tokens": 4, "ignore_eos": True,
                "stream": True,
                "messages": [{"role": "user", "content": "hello"}]}
        for _ in range(2):
            st, _, raw = await _get(service.port, "/v1/chat/completions",
                                    "POST", body)
            assert st == 200 and sse_events(raw)
        assert (await _get(service.port, "/v1/chat/completions", "POST",
                           b"not json"))[0] == 400
        st, _, raw = await _get(service.port, "/metrics")
        text = raw.decode()
        assert ('dynamo_tpu_http_requests_total{dynamo_component="",'
                'dynamo_endpoint="",dynamo_namespace="http",'
                'route="chat_completions",status="200"} 2.0') in text
        assert 'route="chat_completions",status="400"} 1.0' in text
        assert 'dynamo_tpu_ttft_seconds_count{' in text
        st, _, raw = await _get(status.port, "/metrics")
        text = raw.decode()
        assert ('dynamo_tpu_requests_total{dynamo_component="gpu",'
                'dynamo_endpoint="generate",dynamo_namespace="dynamo"} 2.0'
                in text)
    finally:
        await service.stop()
        await watcher.stop()
        await f_rt.close()
        await stop()


@async_test(timeout=120)
async def test_front_profile_never_asks_for_cuda(tmp_path, monkeypatch):
    """On the card's machine ``torch.cuda.is_available()`` is true in the
    frontend too: its ``/debug/profile`` still records CPU activity only
    (it has no kernels, and a CUDA session there would create a context
    and answer 500), while a worker's status server built for an engine
    on the card asks for CUDA activity."""
    import torch

    from dynamo_tpu_torch.runtime import tracing
    asked = []

    async def fake(duration_ms, out_dir, cuda, before_block=None):
        asked.append(cuda)
        return {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tracing, "_torch_profile", fake)
    coord, engine, w_rt, status, stop = await _worker_fleet()
    f_rt, service, watcher = await start_port_front(coord.url)
    card = SystemStatusServer(w_rt, host="127.0.0.1", port=0, cuda=True)
    await card.start()
    try:
        for port, want in ((service.port, False), (status.port, False),
                           (card.port, True)):
            st, body = await _json(port, "/debug/profile", "POST", {
                "duration_ms": 10, "out_dir": str(tmp_path / str(port))})
            assert st == 200 and body["mode"] == "torch", body
            assert asked[-1] is want, (port, asked)
    finally:
        await card.stop()
        await service.stop()
        await watcher.stop()
        await f_rt.close()
        await stop()


@async_test(timeout=120)
async def test_tls_serves_https(tmp_path):
    """``tls_cert_path``/``tls_key_path`` serve HTTPS: a TLS client gets a
    chat back, a plaintext one nothing, and half-configured TLS fails."""
    cert, key = tmp_path / "c.pem", tmp_path / "k.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=localhost"], check=True, capture_output=True)
    coord, engine, w_rt, status, stop = await _worker_fleet()
    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.runtime import config as tconfig
    from dynamo_tpu_torch.runtime import distributed as tdist
    f_rt = await tdist.DistributedRuntime.from_settings(
        tconfig.RuntimeConfig(coordinator_url=coord.url))
    service, watcher = await launch.start_front(
        f_rt, "127.0.0.1", 0, tls_cert_path=str(cert),
        tls_key_path=str(key))
    try:
        await wait_for(lambda: watcher.manager.get(MODEL) is not None)
        ctx = ssl.create_default_context(cafile=str(cert))
        ctx.check_hostname = False

        def https(path, body=None):
            import http.client
            conn = http.client.HTTPSConnection("127.0.0.1", service.port,
                                               context=ctx, timeout=30)
            try:
                conn.request("POST" if body else "GET", path,
                             body=json.dumps(body).encode() if body else None,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()
        assert (await asyncio.to_thread(https, "/health"))[0] == 200
        st, body = await asyncio.to_thread(https, "/v1/chat/completions", {
            "model": MODEL, "max_tokens": 3, "ignore_eos": True,
            "messages": [{"role": "user", "content": "hi"}]})
        assert st == 200 and body["usage"]["completion_tokens"] == 3
        with pytest.raises(Exception):
            await call(service.port, "GET", "/health")
        from dynamo_tpu_torch.llm.discovery import ModelManager
        from dynamo_tpu_torch.llm.http_service import HttpService
        half = HttpService(ModelManager(), port=0, tls_cert_path=str(cert))
        with pytest.raises(ValueError, match="BOTH"):
            await half.start()
    finally:
        await service.stop()
        await watcher.stop()
        await f_rt.close()
        await stop()


def _script(name, *args) -> str:
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / name),
                           *args], capture_output=True, text=True,
                          timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@async_test(timeout=180)
async def test_reference_viewers_render_the_port(tmp_path):
    """The reference's trace and timeline viewers, run as they are, render
    a port front's traces and merged timeline and a port worker's flight
    ring."""
    coord, engine, w_rt, status, stop = await _worker_fleet()
    f_rt, service, watcher = await start_port_front(coord.url)
    collector = TimelineCollector(f_rt)
    await collector.start()
    service.timeline_provider = collector.timeline_status
    await service.stop()
    await service.start()
    pub = journal.JournalPublisher(w_rt.require_coordinator(), "dynamo",
                                   f"{w_rt.instance_id:x}")
    try:
        await wait_for(lambda: watcher.manager.get(MODEL) is not None)
        get_recorder().clear()
        st, _, raw = await _get(service.port, "/v1/chat/completions",
                                "POST", {"model": MODEL, "max_tokens": 8,
                                         "ignore_eos": True,
                                         "messages": [{"role": "user",
                                                       "content": "x"}]})
        assert st == 200
        journal.emit(journal.EventKind.PREEMPT, request="r", slot=0,
                     tokens=3, free_pages=0)
        await pub.flush(force=True)
        await wait_for(lambda: collector.fleet.applied >= 1)
        base = f"http://127.0.0.1:{service.port}"
        waterfall = await asyncio.to_thread(_script, "trace_view.py", base)
        for name in ("http.request", "router.decide", "worker.request",
                     "engine.decode"):
            assert name in waterfall, waterfall
        flight = await asyncio.to_thread(
            _script, "trace_view.py", f"http://127.0.0.1:{status.port}",
            "--flight")
        assert "windows" in flight or "window" in flight, flight
        tree = await asyncio.to_thread(_script, "timeline_view.py", base)
        assert "worker_join" in tree and "preempt" in tree, tree
        tree2 = await asyncio.to_thread(_script, "trace_view.py", base,
                                        "--journal")
        assert tree2 == tree
    finally:
        await collector.stop()
        await service.stop()
        await watcher.stop()
        await f_rt.close()
        await stop()


def test_frontend_serves_the_tls_flags():
    args = frontend_main.parse_args(["--tls-cert-path", "c.pem",
                                     "--tls-key-path", "k.pem"])
    assert (args.tls_cert_path, args.tls_key_path) == ("c.pem", "k.pem")
    assert frontend_main.parse_args([]).tls_cert_path is None
