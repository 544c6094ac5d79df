"""The distributed main path of the port as a whole: coordinator, worker
(``backends/gpu.py``: ``GPUEngine.handler()`` served on the request plane,
``register_llm``) and frontend (``ModelWatcher`` + ``HttpService``), on
tiny-test on the CPU.

- Port stack: the streamed chunks of greedy chats (``ignore_eos``,
  ``max_tokens`` 8, one with logprobs) and of a completion equal, modulo
  ``id``/``created``, those of ``launch.start_http`` over a GPUEngine of
  the same seed, on bf16 and int8 pools.
- Mixed stacks: a JAX ``Coordinator`` and JAX frontend serve a port
  worker's model (discovered, tokenizer fetched from the object store) with
  the same chunks; a port coordinator and port frontend serve a JAX worker
  (``TPUEngine``, the same params) with the port engine's tokens wherever
  the reference's top-2 margin exceeds a bf16 ulp (the rule of
  ``test_torch_engine.py``).
- Two port workers behind ``round_robin``: both serve; with one stopped
  the model stays served; when the last one dies without deregistering,
  the model leaves ``/v1/models`` within the lease TTL.
- A coordinator restarted under a port worker gets its instance and model
  card back, and a frontend serves the model again.
- A model registered while no instance serves it: both fronts answer 503
  with the same body and ``Retry-After``.
- ``Migration`` against the reference's on the scripted cases of
  ``tests/test_migration.py``: the same re-sent prompts, budgets, tokens
  and failures.
- Migration: with a limit of 1, a stream whose worker's endpoint shuts
  down mid-stream (no drain) completes on the other worker with
  ``max_tokens`` tokens; with a limit of 0 the client gets the reference
  front's error status and body.
- The entry points as subprocesses: coordinator, worker and frontend
  print their ready lines, serve a streamed chat and exit 0 on SIGTERM
  (the model leaves ``/v1/models`` when the worker goes);
  ``launch in=http out=dyn`` serves the same chat.
- Refused flags name the ROADMAP item they wait for.

Every server binds 127.0.0.1 port 0 and every wait has its own timeout.
"""

import asyncio
import http.client
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from conftest import async_test
from test_torch_engine import (ENGINE_KW, SPEC_J, SPEC_T, _bf16_ulp,
                               _ref_logits)
from test_torch_http import ROOT, _call, call, sse_events
from test_torch_preprocessor import MODEL, chat, completion, strip_ids

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm.http_service import HttpService as JHttpService
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import coordinator as jcoord
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.frontend import main as frontend_main
from dynamo_tpu_torch.llm.model_card import deregister_llm, register_llm
from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import distributed as tdist
from dynamo_tpu_torch.runtime.context import Context

torch.set_num_threads(1)

TIMEOUT_S = 60
LEASE_TTL_S = 2.0
MAX_TOKENS = 8


def _stream_chat(content, **kw):
    return chat(messages=[{"role": "user", "content": content}],
                max_tokens=MAX_TOKENS, ignore_eos=True, stream=True,
                stream_options={"include_usage": True}, **kw)


BODIES = [
    ("/v1/chat/completions", _stream_chat("the quick brown fox jumps")),
    ("/v1/chat/completions", _stream_chat("hello world", logprobs=True,
                                          top_logprobs=2)),
    ("/v1/chat/completions", _stream_chat("def main(): return 0123456789")),
    ("/v1/completions", completion(max_tokens=MAX_TOKENS, ignore_eos=True,
                                   stream=True,
                                   stream_options={"include_usage": True})),
]


def port_engine(quant_kv=None, params=None) -> GPUEngine:
    engine = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                         quant_kv=quant_kv, **ENGINE_KW),
                       params=params, seed=0)
    engine.start()
    return engine


def tap(engine, record: list, hold: dict | None = None) -> None:
    """Record (prompt ids, emitted ids) of every request the engine serves.
    With ``hold``, the first request served by any engine sharing it is
    held after its first output (until its task is cancelled), and
    ``hold["engine"]`` names the engine that holds it."""
    inner = engine.generate

    async def generate(request, context):
        tokens = []
        record.append((list(request["token_ids"]), tokens))
        held = hold is not None and "engine" not in hold
        if held:
            hold["engine"] = engine
        async for item in inner(request, context):
            tokens.extend(item.get("token_ids", []))
            yield item
            if held:
                hold["event"].set()
                await asyncio.sleep(3600)

    engine.generate = generate


async def _port_runtime(url) -> tdist.DistributedRuntime:
    return await tdist.DistributedRuntime.from_settings(
        tconfig.RuntimeConfig(coordinator_url=url, lease_ttl_s=LEASE_TTL_S))


async def start_port_worker(url, engine, migration_limit=0):
    runtime = await _port_runtime(url)
    server = await gpu.serve_engine(runtime, engine, MODEL,
                                    make_test_tokenizer(),
                                    migration_limit=migration_limit)
    return runtime, server


async def start_port_front(url, router_mode="round_robin"):
    runtime = await _port_runtime(url)
    service, watcher = await launch.start_front(runtime, "127.0.0.1", 0,
                                                router_mode)
    return runtime, service, watcher


async def start_jax_front(url):
    runtime = await jdist.DistributedRuntime.from_settings(
        jconfig.RuntimeConfig(coordinator_url=url, lease_ttl_s=LEASE_TTL_S))
    manager = jdisc.ModelManager()
    watcher = jdisc.ModelWatcher(runtime, manager)
    await watcher.start()
    service = JHttpService(runtime, manager, host="127.0.0.1", port=0)
    await service.start()
    return runtime, service, watcher


async def wait_for(predicate, timeout=TIMEOUT_S) -> float:
    """Seconds until ``predicate()`` held; fails after ``timeout``."""
    t0 = time.monotonic()
    while not predicate():
        assert time.monotonic() - t0 < timeout, "condition never held"
        await asyncio.sleep(0.02)
    return time.monotonic() - t0


async def send_all(port, bodies=BODIES) -> list:
    """Each body's SSE events, sent one after the other."""
    out = []
    for path, body in bodies:
        status, ctype, raw = await call(port, "POST", path, body)
        assert (status, ctype) == (200, "text/event-stream"), raw[:300]
        events = sse_events(raw)
        assert events[-1]["usage"]["completion_tokens"] == MAX_TOKENS
        out.append(strip_ids(events))
    return out


async def _launcher_events(quant_kv):
    args = launch.parse_args(["--model", MODEL, "--device", "cpu",
                              "--http-port", "0"])
    service, engine = await launch.start_http(args,
                                              engine=port_engine(quant_kv))
    try:
        return await send_all(service.port)
    finally:
        await service.stop()
        engine.stop()


@pytest.fixture(scope="module")
def launcher_events():
    """Each pool's chunks from the one-process launcher, computed once."""
    return {q: asyncio.run(asyncio.wait_for(_launcher_events(q), 120))
            for q in (None, "int8")}


@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
@async_test(timeout=120)
async def test_port_stack_equals_launcher(quant_kv, launcher_events):
    want = launcher_events[quant_kv]
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    engine = port_engine(quant_kv)
    w_rt, server = await start_port_worker(coord.url, engine)
    f_rt, service, watcher = await start_port_front(coord.url)
    try:
        await wait_for(lambda: watcher.manager.get(MODEL) is not None)
        status, _, raw = await call(service.port, "GET", "/v1/models")
        assert status == 200 and b'"tiny-test"' in raw
        assert await send_all(service.port) == want
    finally:
        await service.stop()
        await watcher.stop()
        await server.shutdown()
        engine.stop()
        await f_rt.close()
        await w_rt.close()
        await coord.stop()


@async_test(timeout=120)
async def test_jax_frontend_serves_port_worker(launcher_events):
    want = launcher_events[None]
    coord = jcoord.Coordinator()
    await coord.start()
    engine = port_engine()
    w_rt, server = await start_port_worker(coord.url, engine)
    f_rt, service, watcher = await start_jax_front(coord.url)
    try:
        await wait_for(lambda: watcher.manager.get(MODEL) is not None)
        served = watcher.manager.get(MODEL)
        # The tokenizer came from the port worker's object-store blob.
        assert served.entry.card.tokenizer_key.startswith(f"tokenizers/{MODEL}-")
        assert served.preprocessor.tokenizer.to_bytes() == \
            make_test_tokenizer().to_bytes()
        status, _, raw = await call(service.port, "GET", "/v1/models")
        assert status == 200 and b'"tiny-test"' in raw
        assert await send_all(service.port) == want
    finally:
        await service.stop()
        await watcher.stop()
        await server.shutdown()
        engine.stop()
        await f_rt.close()
        await w_rt.close()
        await coord.stop()


@async_test(timeout=180)
async def test_port_frontend_serves_jax_worker():
    jparams = jmodel.init_params(SPEC_J, jax.random.key(44))
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW), params=jparams)
    teng = port_engine(params=params_from_jax(
        jax.tree.map(np.asarray, jparams), SPEC_T, device="cpu"))
    seen = []
    tap(jeng, seen)
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    w_rt = await jdist.DistributedRuntime.from_settings(
        jconfig.RuntimeConfig(coordinator_url=coord.url,
                              lease_ttl_s=LEASE_TTL_S))
    ep = w_rt.namespace("dynamo").component("tpu").endpoint("generate")
    server = await ep.serve_endpoint(jeng.handler(), graceful_shutdown=False)
    await jcard.register_llm(w_rt, ep, MODEL, j_test_tokenizer(),
                             context_length=256)
    f_rt, service, watcher = await start_port_front(coord.url)
    try:
        await wait_for(lambda: watcher.manager.get(MODEL) is not None)
        chats = [b for b in BODIES if b[0] == "/v1/chat/completions"]
        await send_all(service.port, chats)
        assert len(seen) == len(chats)
        compared = 0
        for prompt, rt in seen:
            assert len(rt) == MAX_TOKENS
            req = {"model": MODEL, "token_ids": prompt,
                   "stop_conditions": {"max_tokens": MAX_TOKENS,
                                       "ignore_eos": True}}
            gt = []
            async for item in teng.generate(req, Context()):
                gt.extend(item["token_ids"])
            for i, (a, b) in enumerate(zip(rt, gt)):
                if a == b:
                    compared += 1
                    continue
                top2 = np.sort(_ref_logits(jparams, prompt + rt[:i]))[-2:]
                margin = float(top2[1] - top2[0])
                assert margin <= _bf16_ulp(top2[1]), (
                    f"token {i}: port {b} != reference {a} at a clear "
                    f"margin {margin:.4f}")
                break  # a legitimate near-tie split: the chains diverge
        assert compared >= MAX_TOKENS
    finally:
        await service.stop()
        await watcher.stop()
        await server.shutdown()
        jeng.stop()
        teng.stop()
        await f_rt.close()
        await w_rt.close()
        await coord.stop()


async def _two_workers(migration_limit=0, hold=None):
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    engines, records, workers = [], [], []
    for _ in range(2):
        engines.append(port_engine())
        records.append([])
        tap(engines[-1], records[-1], hold)
        workers.append(await start_port_worker(coord.url, engines[-1],
                                               migration_limit))
    f_rt, service, watcher = await start_port_front(coord.url)
    await wait_for(lambda: watcher.manager.get(MODEL) is not None
                   and len(watcher.manager.get(MODEL).client.instance_ids())
                   == 2)

    async def stop():
        await service.stop()
        await watcher.stop()
        for (rt, server), engine in zip(workers, engines):
            await server.shutdown(drain_s=0)
            engine.stop()
            await rt.close()
        await f_rt.close()
        await coord.stop()
    return engines, records, workers, service, watcher, stop


@async_test(timeout=120)
async def test_two_workers_round_robin_and_model_removal():
    engines, records, workers, service, watcher, stop = await _two_workers()
    try:
        for i in range(4):
            await send_all(service.port, [BODIES[i % 2]])
        assert [len(r) for r in records] == [2, 2]
        # One worker stops: the model stays served, by the other.
        rt, server = workers[0]
        await deregister_llm(rt, MODEL)
        await server.shutdown()
        await rt.close()
        served = watcher.manager.get(MODEL)
        await wait_for(lambda: len(served.instances) == 1
                       and len(served.client.instance_ids()) == 1)
        await send_all(service.port, [BODIES[2]])
        assert [len(r) for r in records] == [2, 3]
        status, _, raw = await call(service.port, "GET", "/v1/models")
        assert status == 200 and b'"tiny-test"' in raw
        # The last worker dies without deregistering: the model leaves
        # /v1/models once its lease expires.
        rt, server = workers[1]
        await rt.coordinator_client.close(revoke_lease=False)
        await server.shutdown(drain_s=0)
        took = await wait_for(lambda: watcher.manager.get(MODEL) is None,
                              timeout=LEASE_TTL_S + 1.5)
        assert took > LEASE_TTL_S / 2, took
        status, _, raw = await call(service.port, "GET", "/v1/models")
        assert status == 200 and b'"tiny-test"' not in raw
        status, _, raw = await call(service.port, "POST",
                                    "/v1/chat/completions", BODIES[0][1])
        assert status == 404, raw
    finally:
        await stop()


@async_test(timeout=120)
async def test_migration_completes_the_stream():
    hold = {"event": asyncio.Event()}
    engines, records, workers, service, _, stop = await _two_workers(
        migration_limit=1, hold=hold)
    try:
        body = _stream_chat("the quick brown fox jumps over the lazy dog")
        request = asyncio.ensure_future(call(service.port, "POST",
                                             "/v1/chat/completions", body))
        await asyncio.wait_for(hold["event"].wait(), TIMEOUT_S)
        victim = engines.index(hold["engine"])
        await workers[victim][1].shutdown(drain_s=0)
        status, _, raw = await asyncio.wait_for(request, TIMEOUT_S)
        assert status == 200
        events = sse_events(raw)
        assert events[-1]["usage"]["completion_tokens"] == MAX_TOKENS
        assert events[-2]["choices"][0]["finish_reason"] == "length"
        (prompt, first), = records[victim]
        (retry_prompt, rest), = records[1 - victim]
        # The retry carries the tokens already produced.
        assert retry_prompt == prompt + first
        assert len(first) + len(rest) == MAX_TOKENS
    finally:
        await stop()


@pytest.mark.parametrize("front", ["port", "jax"])
@async_test(timeout=120)
async def test_no_migration_gives_the_reference_error(front):
    hold = {"event": asyncio.Event()}
    engines, _, workers, service, _, stop = await _two_workers(hold=hold)
    f_rt = jservice = jwatcher = None
    try:
        port = service.port
        if front == "jax":
            f_rt, jservice, jwatcher = await start_jax_front(
                workers[0][0].config.coordinator_url)
            await wait_for(lambda: jwatcher.manager.get(MODEL) is not None)
            port = jservice.port
        body = dict(_stream_chat("hello world"), stream=False)
        request = asyncio.ensure_future(call(port, "POST",
                                             "/v1/chat/completions", body))
        await asyncio.wait_for(hold["event"].wait(), TIMEOUT_S)
        await workers[engines.index(hold["engine"])][1].shutdown(drain_s=0)
        status, ctype, raw = await asyncio.wait_for(request, TIMEOUT_S)
        assert status == 500 and ctype.startswith("application/json")
        assert json.loads(raw) == {"error": {
            "message": "internal error: Stream ended before generation "
                       "completed", "type": "internal_error", "param": None,
            "code": None}}
    finally:
        if jservice is not None:
            await jservice.stop()
            await jwatcher.stop()
            await f_rt.close()
        await stop()


@async_test(timeout=120)
async def test_worker_registrations_survive_coordinator_restart():
    """A port worker's instance and model card come back after its
    coordinator restarts on the same port (lease re-grant replays both),
    and a port frontend started afterwards serves the model."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = tcoord.Coordinator("127.0.0.1", port)
    await coord.start()
    engine = port_engine()
    w_rt, server = await start_port_worker(coord.url, engine)
    coord2 = front = None
    try:
        client = w_rt.require_coordinator()
        await coord.stop()
        await asyncio.sleep(0.5)
        coord2 = tcoord.Coordinator("127.0.0.1", port)
        await coord2.start()
        keys = {}

        async def registered():
            try:
                keys["i"] = await client.kv_get_prefix("instances/")
                keys["m"] = await client.kv_get_prefix("models/")
            except ConnectionError:
                return False
            return bool(keys["i"] and keys["m"])

        deadline = time.monotonic() + TIMEOUT_S
        while not await registered():
            assert time.monotonic() < deadline, "registrations never came back"
            await asyncio.sleep(0.1)
        iid = f"{w_rt.instance_id:x}"
        assert [k["k"] for k in keys["m"]] == [f"models/{MODEL}/{iid}"]
        assert keys["i"][0]["k"].endswith(f"/gpu/generate/{iid}")
        front = await start_port_front(coord2.url)
        await wait_for(lambda: front[2].manager.get(MODEL) is not None)
        await send_all(front[1].port, [BODIES[0]])
    finally:
        if front is not None:
            f_rt, service, watcher = front
            await service.stop()
            await watcher.stop()
            await f_rt.close()
        await server.shutdown()
        engine.stop()
        await w_rt.close()
        if coord2 is not None:
            await coord2.stop()


def _call_with_retry_after(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), json.loads(
            resp.read())
    finally:
        conn.close()


@async_test(timeout=60)
async def test_model_without_instances_is_a_503_on_both_fronts():
    """A model whose entry is registered while no instance serves its
    endpoint: both fronts answer 503 with the same body and Retry-After."""
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    w_rt = await _port_runtime(coord.url)
    ep = w_rt.namespace().component("gpu").endpoint("generate")
    await register_llm(w_rt, ep, MODEL, make_test_tokenizer())
    fronts = [await start_port_front(coord.url),
              await start_jax_front(coord.url)]
    try:
        answers = []
        for _, service, watcher in fronts:
            await wait_for(lambda: watcher.manager.get(MODEL) is not None)
            answers.append(await asyncio.to_thread(
                _call_with_retry_after, service.port, BODIES[0][1]))
        assert answers[0] == answers[1]
        status, retry_after, body = answers[0]
        assert (status, retry_after) == (503, "1")
        assert body["error"]["type"] == "service_unavailable"
        assert body["error"]["message"] == \
            "no instances for dynamo/gpu/generate"
    finally:
        for rt, service, watcher in fronts:
            await service.stop()
            await watcher.stop()
            await rt.close()
        await w_rt.close()
        await coord.stop()


class FlakyEngine:
    """Per attempt: yield n tokens, then die with the package's
    StreamIncompleteError or finish; records each request it saw."""

    def __init__(self, script, incomplete):
        self.script = list(script)
        self.incomplete = incomplete
        self.seen = []

    async def generate(self, request, context):
        self.seen.append((len(request["token_ids"]),
                          request["stop_conditions"].get("max_tokens")))
        n, dies = self.script.pop(0)
        budget = request["stop_conditions"].get("max_tokens")
        base = 1000 + len(request["token_ids"])
        for i in range(n if budget is None else min(n, budget)):
            yield {"token_ids": [base + i]}
        if dies:
            raise self.incomplete()
        yield {"token_ids": [], "finish_reason": "length"}


MIGRATIONS = {  # name: (script, migration limit, max_tokens, stop early)
    "budget_shrinks": ([(4, True), (99, False)], 3, 10, False),
    "died_on_the_boundary": ([(5, True), (99, False)], 3, 5, False),
    "stopped_context": ([(2, True), (99, False)], 3, 10, True),
    "repeated": ([(3, True), (2, True), (99, False)], 5, 12, False),
    "limit_exhausted": ([(1, True)] * 3, 2, 10, False),
    "limit_zero": ([(2, True)], 0, 10, False),
}


@pytest.mark.parametrize("name", list(MIGRATIONS))
@async_test(timeout=60)
async def test_migration_matches_reference(name):
    """The port's Migration re-sends what the reference's does, with the
    same carried tokens and budgets, and fails the same way."""
    from dynamo_tpu.llm.migration import Migration as JMigration
    from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
    from dynamo_tpu.runtime.context import Context as JContext
    from dynamo_tpu.runtime.errors import StreamIncompleteError as JIncomplete
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
    from dynamo_tpu_torch.runtime.errors import StreamIncompleteError

    script, limit, max_tokens, stop_early = MIGRATIONS[name]
    records = []
    for mig_cls, req_cls, ctx_cls, err in (
            (JMigration, JRequest, JContext, JIncomplete),
            (Migration, PreprocessedRequest, Context, StreamIncompleteError)):
        engine = FlakyEngine(script, err)
        req = req_cls(model="m", token_ids=[1, 2, 3])
        req.stop_conditions.max_tokens = max_tokens
        ctx, tokens, failure = ctx_cls(), [], None
        try:
            async for out in mig_cls(limit, inner=engine).generate(req, ctx):
                tokens.extend(out.token_ids)
                if stop_early:
                    ctx.stop_generating()
        except Exception as exc:  # noqa: BLE001 — the outcome is the record
            failure = type(exc).__name__
        records.append((tokens, engine.seen, failure))
    assert records[1] == records[0]
    assert len(records[0][1]) == {"died_on_the_boundary": 1,
                                  "stopped_context": 1, "limit_zero": 1,
                                  "repeated": 3}.get(name, len(script))


# -- the entry points as processes ---------------------------------------------

class Proc:
    """A subprocess whose stdout and stderr lines are collected."""

    def __init__(self, *argv):
        env = dict(os.environ, OMP_NUM_THREADS="1", DTPU_LOG="info",
                   DTPU_LEASE_TTL_S=str(LEASE_TTL_S))
        self.p = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
        self.lines: queue.Queue = queue.Queue()
        self.seen: list[str] = []
        for pipe in (self.p.stdout, self.p.stderr):
            threading.Thread(target=lambda f=pipe: [self.lines.put(x)
                                                    for x in f],
                             daemon=True).start()

    def wait_line(self, text: str) -> str:
        """The first line that holds ``text``, waiting for it (also from
        a process that has exited, among the lines it wrote)."""
        deadline = time.monotonic() + TIMEOUT_S
        while True:
            for line in self.seen:
                if text in line:
                    return line.strip()
            try:
                self.seen.append(self.lines.get(timeout=0.5))
                continue
            except queue.Empty:
                pass
            assert self.p.poll() is None, (self.p.returncode, self.seen[-20:])
            assert time.monotonic() < deadline, self.seen[-20:]

    def port(self, text: str) -> int:
        return int(self.wait_line(text).rsplit("port=", 1)[1].split()[0])

    def stop(self) -> int:
        self.p.send_signal(signal.SIGTERM)
        return self.p.wait(timeout=TIMEOUT_S)

    def kill(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait(timeout=TIMEOUT_S)
        self.p.stdout.close()
        self.p.stderr.close()


def _models(port) -> bytes:
    status, _, raw = _call(port, "GET", "/v1/models")
    assert status == 200
    return raw


def test_entry_points_as_processes():
    procs = []
    try:
        coord = Proc("dynamo_tpu_torch.runtime.coordinator", "--host",
                     "127.0.0.1", "--port", "0")
        procs.append(coord)
        url = f"tcp://127.0.0.1:{coord.port('COORDINATOR_READY')}"
        worker = Proc("dynamo_tpu_torch.backends.gpu", "--model", MODEL,
                      "--device", "cpu", "--num-pages", "64",
                      "--coordinator-url", url)
        front = Proc("dynamo_tpu_torch.frontend", "--http-host",
                     "127.0.0.1", "--http-port", "0", "--coordinator-url",
                     url)
        dyn = Proc("dynamo_tpu_torch.launch", "in=http", "out=dyn",
                   "--http-port", "0", "--coordinator-url", url)
        procs += [worker, front, dyn]
        ready = worker.wait_line("GPU_WORKER_READY")
        assert ready.startswith("GPU_WORKER_READY mode=agg port=")
        assert "pages=64" in ready
        worker.wait_line("from an engine on cpu")
        fport = front.port("FRONTEND_READY")
        dport = dyn.port("LAUNCH_READY in=http out=dyn")
        for port in (fport, dport):
            deadline = time.monotonic() + TIMEOUT_S
            while b'"tiny-test"' not in _models(port):
                assert time.monotonic() < deadline
                time.sleep(0.05)
            status, ctype, raw = _call(port, "POST", "/v1/chat/completions",
                                       _stream_chat("hello world"))
            assert (status, ctype) == (200, "text/event-stream")
            events = sse_events(raw)
            assert events[-1]["usage"]["completion_tokens"] == MAX_TOKENS
        assert worker.stop() == 0, worker.seen[-20:]
        deadline = time.monotonic() + TIMEOUT_S
        while b'"tiny-test"' in _models(fport):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        for proc in (dyn, front, coord):
            assert proc.stop() == 0, proc.seen[-20:]
    finally:
        for proc in procs:
            proc.kill()


@pytest.mark.parametrize("main,argv,words", [
    (gpu.parse_args, ["--pp", "2"], "ROADMAP item 16"),
    (gpu.parse_args, ["--num-nodes", "2"], "ROADMAP item 16"),
    (gpu.parse_args, ["--tp", "2"], "ROADMAP item 16"),
    (gpu.parse_args, ["--standby"], {"standby": True}),
    (gpu.parse_args, ["--tool-call-parser", "hermes"],
     {"tool_call_parser": "hermes"}),
    (frontend_main.parse_args, ["--grpc-port", "9"], "gRPC"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_refused_flags_name_their_item(main, argv, words, capsys):
    """Each refused flag exits naming its item; ``--standby`` and
    ``--tool-call-parser`` (``words`` a dict) are served now: the worker
    parses them into those values (it parks as a standby; it names the
    parser on its cards)."""
    if isinstance(words, dict):
        args = main(argv)
        assert {k: getattr(args, k) for k in words} == words
        return
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code != 0
    assert words in capsys.readouterr().err


_WORKER_ARGV = ["--model", "tiny-test", "--device", "cpu", "--num-pages",
                "8"]


@pytest.mark.parametrize("argv,want", [
    (["--ttft-budget-ms", "500"], (500.0, 2.0)),
    (["--ttft-budget-ms", "500", "--admission-reject-factor", "3"],
     (500.0, 3.0)),
    (["--admission-reject-factor", "3"], (None, 0.0)),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_worker_serves_the_admission_flags(argv, want):
    """--ttft-budget-ms and --admission-reject-factor reach the engine
    config as the reference worker sets them: the factor (default 2) only
    with a budget."""
    cfg = gpu.build_engine_config(gpu.parse_args([*_WORKER_ARGV, *argv]))
    assert (cfg.ttft_budget_ms, cfg.admission_reject_factor) == want


@pytest.mark.parametrize("argv,check", [
    (["--slo-ttft-p99-ms", "500"], lambda c: c.slo.ttft_p99_ms == 500.0),
    (["--canary"], None),
    (["--request-log", "r.jsonl"],
     lambda c: c.slo.request_log_path == "r.jsonl"),
    (["--no-overload-defense"], lambda c: not c.overload.enabled),
    (["--overload-max-concurrency", "4", "--default-deadline-ms", "900"],
     lambda c: (c.overload.max_concurrency, c.overload.default_deadline_ms)
     == (4, 900.0)),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_frontend_serves_the_overload_slo_and_canary_flags(argv, check):
    """The reference frontend's overload, SLO, request-log and canary
    flags land where the reference's do (``--canary`` on the prober's
    config)."""
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    args = frontend_main.parse_args(argv)
    cfg = RuntimeConfig()
    frontend_main.apply_front_args(cfg, args)
    if check is None:
        assert frontend_main.canary_config(args).enabled
    else:
        assert check(cfg)


@pytest.mark.parametrize("argv,words", [
    (["--tp", "2"], "ROADMAP item 16"),
    (["--dp", "2"], "ROADMAP item 16"),
    (["--pp", "2"], "ROADMAP item 16"),
    (["--sp", "2"], "ROADMAP item 16"),
    (["--attention-backend", "pallas"], "no ROADMAP item"),
    (["--warmup-prefill-ladder"], "no ROADMAP item"),
    (["--tool-call-parser", "hermes"], {"tool_call_parser": "hermes"}),
    (["--reasoning-parser", "deepseek_r1"],
     {"reasoning_parser": "deepseek_r1"}),
    (["--input-file", "prompts.jsonl"], {"input_file": "prompts.jsonl"}),
    (["--output-file", "out.jsonl"], {"output_file": "out.jsonl"}),
    (["--batch-concurrency", "4"], {"batch_concurrency": 4}),
    (["--batch-max-tokens", "64"], {"batch_max_tokens": 64}),
    (["out=mocker"], None),
    (["out=echo"], "no ROADMAP item"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_launcher_refused_flags_name_their_item(argv, words, capsys):
    """Every flag of the reference launcher that the port does not serve,
    and out=echo, exit naming what they wait for; out=mocker (``words``
    None) is served now: it parses and builds the mocker's pipeline. The
    parser and batch flags (``words`` a dict) are served too: they parse
    into those values."""
    if isinstance(words, dict):
        args = launch.parse_args(["in=http", "out=gpu", *argv])
        assert {k: getattr(args, k) for k in words} == words
        return
    if words is None:
        args = launch.parse_args(["in=http", "out=gpu", *argv])
        assert args.output == "mocker"
        served, engine = _mocker_served(args)
        assert type(engine).__name__ == "MockerEngine"
        assert served.name == "tiny-test"
        return
    with pytest.raises(SystemExit) as exc:
        launch.parse_args(["in=http", "out=gpu", *argv])
    assert exc.value.code != 0
    assert words in capsys.readouterr().err


def _mocker_served(args):
    """``build_local_served`` of an out=mocker launch, on a loop of its
    own (the mocker starts its loop task there), stopped after."""
    async def build():
        served, engine = launch.build_local_served(args)
        await launch.stop_engine(engine)
        return served, engine
    return asyncio.run(build())


@pytest.mark.parametrize("argv,want", [
    (["--slo-ttft-p99-ms", "500"], (500.0, "")),
    (["--request-log", "requests.jsonl"], (0.0, "requests.jsonl")),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_launcher_serves_the_slo_flags(argv, want):
    """The launcher's --slo-ttft-p99-ms and --request-log set the SLO
    plane's settings, as the reference launcher's do."""
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    args = launch.parse_args(["in=http", "out=gpu", *argv])
    cfg = RuntimeConfig()
    launch.apply_slo_args(cfg, args)
    assert (cfg.slo.ttft_p99_ms, cfg.slo.request_log_path) == want


def test_launcher_takes_the_reference_defaults_of_refused_flags():
    args = launch.parse_args([
        "--tp", "1", "--dp", "1", "--pp", "1", "--sp", "1",
        "--attention-backend", "auto", "--batch-concurrency", "8",
        "--batch-max-tokens", "128"])
    assert (args.input, args.output, args.tp, args.attention_backend) == (
        "http", "gpu", 1, "auto")


@pytest.mark.parametrize("argv,want", [
    (["--spec-decode", "ngram", "--spec-k", "3"], ("ngram", 3)),
    (["--spec-decode", "ngram", "--spec-k", "5"], ("ngram", 5)),
    ([], (None, 3)),
    (["--spec-decode", "foo"], "invalid choice: 'foo'"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_spec_decode_flags(argv, want, capsys):
    """The worker serves --spec-decode (choices: ngram) and --spec-k, as
    the reference worker does; another choice is refused by argparse."""
    argv = ["--model", "tiny-test", "--device", "cpu", "--num-pages", "8",
            *argv]
    if isinstance(want, str):
        with pytest.raises(SystemExit) as exc:
            gpu.parse_args(argv)
        assert exc.value.code == 2
        assert want in capsys.readouterr().err
        return
    config = gpu.build_engine_config(gpu.parse_args(argv))
    assert (config.spec_decode, config.spec_k) == want
    assert config.warmup_windows


def test_defaults_of_the_entry_points():
    args = gpu.parse_args(["--mode", "agg", "--tp", "1"])
    assert (args.device, args.component, args.endpoint, args.mode) == (
        "cuda", "gpu", "generate", "agg")
    args = frontend_main.parse_args([])
    assert (args.router_mode, args.http_port) == ("round_robin", 8000)
    assert frontend_main.kv_router_factory(args) is None
    # The KV router's flags, at the reference frontend's defaults.
    args = frontend_main.parse_args(["--router-mode", "kv"])
    assert (args.kv_overlap_score_weight, args.kv_router_temperature,
            args.no_kv_federation, args.busy_threshold) == (
        1.0, 0.0, False, None)
    assert callable(frontend_main.kv_router_factory(args))
    args = frontend_main.parse_args(
        ["--router-mode", "kv", "--kv-overlap-score-weight", "2",
         "--kv-router-temperature", "0.5", "--no-kv-federation",
         "--busy-threshold", "0.9"])
    assert (args.kv_overlap_score_weight, args.kv_router_temperature,
            args.no_kv_federation, args.busy_threshold) == (
        2.0, 0.5, True, 0.9)
    with pytest.raises(SystemExit):
        frontend_main.parse_args(["--router-mode", "least_loaded"])


def test_refused_flags_in_a_process():
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.backends.gpu",
         "--tp", "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert proc.returncode != 0 and "ROADMAP item 16" in proc.stderr
