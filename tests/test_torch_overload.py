"""The port's overload defense (``dynamo_tpu_torch.runtime.overload``, the
front's admission, the endpoint client's breakers) against the JAX
package's, on the CPU.

- The same scripted event sequences (admissions by priority and deadline,
  completions with latencies, cancellations, clock steps, the seed)
  through both packages' ``AdaptiveLimiter`` give equal decisions: each
  admission's outcome (granted, queued, or the typed error with its
  message and ``Retry-After``), and after every event the concurrency
  limit, inflight, waiters, pressure and pressure level, the service-time
  EWMA and the brownout clamp. Exact: both run the same float arithmetic
  and the same seeded ``random.Random`` stream.
- The same failure/success/latency/clock sequences through both
  ``CircuitBreaker`` and ``BreakerBoard`` give equal states, streaks,
  open counts and admitted sets. Exact.
- ``[overload]`` TOML under ``DTPU_OVERLOAD_*`` env layers into the same
  settings in both packages.
- Both fronts over one gated scripted engine, each with a one-slot
  limiter: the same statuses, OpenAI error bodies and ``Retry-After``
  headers for a queue-full 503, a batch 429 under brownout and a bad
  overload header (400), and the same 200 once the slot frees.
- A port front over a JAX worker whose handler answers ``rate_limited: ``
  and ``overloaded: ``: 429 and 503 with ``Retry-After``.
- A port client's breaker opens on a stalled JAX worker (the idle
  deadline types each stall), the client sheds while it is open, and the
  half-open probe after the cooldown closes it.

Clocks are fake wherever the code takes one; the e2e cases wait only on
sub-second request-plane deadlines.
"""

import asyncio
import dataclasses
import json

import pytest
import torch
from conftest import async_test
from test_torch_http import _j_served, _t_served
from test_torch_preprocessor import MODEL, chat, pipelines

from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm.http_service import HttpService as JHttpService
from dynamo_tpu.llm.model_card import register_llm as j_register_llm
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import errors as jerrors
from dynamo_tpu.runtime import overload as jov
from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm.http_service import HttpService as THttpService
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import errors as terrors
from dynamo_tpu_torch.runtime import overload as tov
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import AsyncEngine

torch.set_num_threads(1)

TIMEOUT_S = 60


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# -- the limiter ---------------------------------------------------------------

def _outcome(task: asyncio.Task):
    if not task.done():
        return "waiting"
    if task.cancelled():
        return "cancelled"
    exc = task.exception()
    if exc is None:
        return ("granted", task.result().priority)
    return (type(exc).__name__, str(exc), exc.retry_after_s,
            getattr(exc, "shed_reason", None))


async def drive_limiter(mod, script, **cfg):
    """Run ``script`` through ``mod.AdaptiveLimiter`` under a fake clock;
    the trace of every admission's outcome and the limiter's state after
    each event."""
    clk = FakeClock()
    lim = mod.AdaptiveLimiter(mod.OverloadConfig(**cfg), clock=clk)
    tasks: list[asyncio.Task] = []
    trace = []
    for op in script:
        kind = op[0]
        if kind == "admit":
            tasks.append(asyncio.ensure_future(lim.admit(*op[1:])))
        elif kind == "done":  # ("done", admission index, latency or None)
            permit = tasks[op[1]].result()
            if op[2] is not None:
                permit.note_latency(op[2])
            permit.release()
        elif kind == "cancel":
            tasks[op[1]].cancel()
        elif kind == "advance":
            clk.advance(op[1])
        elif kind == "retry_after":
            trace.append(("retry_after", lim.retry_after_s()))
        elif kind == "clamp":
            trace.append(("clamp", lim.clamp_max_tokens(op[1])))
        for _ in range(3):
            await asyncio.sleep(0)
        trace.append((op, [_outcome(t) for t in tasks], lim.limit,
                      lim.inflight, lim.waiting(), lim.pressure(),
                      lim.pressure_level(), lim.avg_service_s,
                      dict(lim.admitted_total), dict(lim.shed_counts)))
    for t in tasks:
        if not t.done():
            t.cancel()
    await asyncio.sleep(0)
    return trace


A = ("admit", "interactive", None)
B = ("admit", "batch", None)

LIMITER_SCRIPTS = {
    # AIMD: under-target completions grow the limit additively, an
    # over-target one shrinks it once per cooldown.
    "aimd": (dict(initial_concurrency=2, target_latency_ms=100.0,
                  decrease_cooldown_s=1.0),
             [A, A, ("done", 0, 0.05), ("done", 1, 0.05), A, A, A,
              ("done", 2, 0.5), ("done", 3, 0.5), ("advance", 1.5),
              ("done", 4, 0.5), A, ("done", 5, 0.01), ("retry_after",)]),
    # A bounded queue: waiters are granted as slots free, the overflow is
    # a typed 503.
    "queue_bound": (dict(initial_concurrency=1, queue_depth=2),
                    [A, A, A, A, ("retry_after",), ("done", 0, 0.2),
                     ("done", 1, 0.2), ("done", 2, 0.2)]),
    # Deadline projection: once calibrated, an infeasible deadline sheds
    # at once (429), a feasible one waits.
    "deadline": (dict(initial_concurrency=1, max_concurrency=1,
                      queue_depth=8),
                 [A, ("done", 0, 2.0), A, ("admit", "interactive", 500.0),
                  ("admit", "interactive", 5000.0), ("done", 1, 2.0),
                  ("retry_after",)]),
    # Priorities: batch sheds at the brownout level, interactive waiters
    # are granted first.
    "priority": (dict(initial_concurrency=1, queue_depth=4,
                      batch_shed_level=2),
                 [A, B, A, A, A, B, ("done", 0, 0.1), ("done", 2, 0.1),
                  ("done", 3, 0.1), ("done", 4, 0.1), ("done", 1, 0.1)]),
    # A cancelled waiter leaks no capacity.
    "cancel": (dict(initial_concurrency=1, queue_depth=4),
               [A, A, A, ("cancel", 1), ("done", 0, 0.1), ("done", 2, 0.1),
                A]),
    # Brownout clamp and pressure levels as the queue fills.
    "clamp": (dict(initial_concurrency=1, queue_depth=4,
                   brownout_max_tokens=32, brownout_clamp_level=2),
              [("clamp", 100), A, ("clamp", 100), A, A, ("clamp", 100),
               ("clamp", 8), A, ("clamp", 100), ("done", 0, 0.1),
               ("done", 1, 0.1), ("done", 2, 0.1), ("done", 3, 0.1),
               ("clamp", 100)]),
    # Another seed: another Retry-After stream, the same in both.
    "seed": (dict(initial_concurrency=1, max_concurrency=1, queue_depth=1,
                  seed=1234),
             [A, ("done", 0, 0.7), A, A, A, ("retry_after",),
              ("retry_after",)]),
}


@pytest.mark.parametrize("name", sorted(LIMITER_SCRIPTS))
def test_limiter_decisions_equal_reference(name):
    cfg, script = LIMITER_SCRIPTS[name]
    ref = asyncio.run(drive_limiter(jov, script, **cfg))
    got = asyncio.run(drive_limiter(tov, script, **cfg))
    assert got == ref
    # Each script reaches the decision it is named for.
    outcomes = {o if isinstance(o, str) else o[0]
                for step in ref if len(step) > 2 for o in step[1]}
    want = {"aimd": "granted", "queue_bound": "OverloadedError",
            "deadline": "RateLimitedError", "priority": "RateLimitedError",
            "cancel": "cancelled", "clamp": "granted",
            "seed": "OverloadedError"}[name]
    assert want in outcomes, outcomes


def test_limiter_seeded_retry_after_equals_reference():
    jl = jov.AdaptiveLimiter(jov.OverloadConfig(seed=7), clock=FakeClock())
    tl = tov.AdaptiveLimiter(tov.OverloadConfig(seed=7), clock=FakeClock())
    for lim in (jl, tl):
        lim.avg_service_s = 3.0
    assert [tl.retry_after_s() for _ in range(16)] == \
        [jl.retry_after_s() for _ in range(16)]


# -- breakers ------------------------------------------------------------------

BREAKER_SCRIPTS = {
    "failures": [("fail",), ("fail",), ("ok", None), ("fail",), ("fail",),
                 ("fail",), ("allows",), ("advance", 1.0), ("allows",),
                 ("advance", 1.5), ("allows",), ("dispatch",), ("allows",),
                 ("ok", 0.1), ("allows",)],
    "probe_fails": [("fail",)] * 3 + [("advance", 2.5), ("allows",),
                                      ("dispatch",), ("fail",), ("allows",),
                                      ("advance", 2.5), ("allows",),
                                      ("dispatch",), ("ok", 0.2)],
    "outliers": [("ok", 0.1)] * 5 + [("ok", 100.0), ("ok", 0.1),
                                     ("ok", 100.0), ("ok", 1000.0),
                                     ("ok", 10000.0), ("allows",)],
}


def drive_breaker(mod, script):
    clk = FakeClock()
    cfg = mod.OverloadConfig(breaker_failures=3, breaker_cooldown_s=2.0,
                             breaker_latency_factor=5.0,
                             breaker_min_samples=4)
    b = mod.CircuitBreaker(cfg, clk)
    trace = []
    for op in script:
        out = None
        if op[0] == "fail":
            b.record_failure()
        elif op[0] == "ok":
            b.record_success(op[1])
        elif op[0] == "advance":
            clk.advance(op[1])
        elif op[0] == "dispatch":
            b.on_dispatch()
        elif op[0] == "allows":
            out = b.allows()
        trace.append((op, out, b.state, b.streak, b.opens,
                      b.probe_inflight, b.ewma_latency_s, b.samples))
    return trace


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_states_equal_reference(name):
    script = BREAKER_SCRIPTS[name]
    ref = drive_breaker(jov, script)
    assert drive_breaker(tov, script) == ref
    assert any(step[2] == "open" for step in ref)


def test_board_equals_reference():
    def drive(mod):
        clk = FakeClock()
        board = mod.BreakerBoard(mod.OverloadConfig(breaker_failures=2,
                                                    breaker_cooldown_s=1.0),
                                 clock=clk)
        trace = []
        for op in [("fail", 1), ("fail", 1), ("fail", 2), ("hold", 3),
                   ("adm",), ("advance", 1.5), ("adm",), ("dispatch", 1),
                   ("adm",), ("ok", 1, 0.1), ("ok", 3, 0.1), ("adm",),
                   ("remove", 2), ("adm",)]:
            if op[0] == "fail":
                board.record_failure(op[1])
            elif op[0] == "ok":
                board.record_success(op[1], op[2])
            elif op[0] == "hold":
                board.hold(op[1])
            elif op[0] == "dispatch":
                board.on_dispatch(op[1])
            elif op[0] == "remove":
                board.remove(op[1])
            elif op[0] == "advance":
                clk.advance(op[1])
            trace.append((op, board.admitted([1, 2, 3]),
                          [board.state(w) for w in (1, 2, 3)]))
        return trace
    assert drive(tov) == drive(jov)


# -- settings ------------------------------------------------------------------

def test_overload_env_and_toml_layering(tmp_path, monkeypatch):
    """The reference's layering case, through both packages."""
    toml = tmp_path / "rt.toml"
    toml.write_text("[overload]\nqueue_depth = 99\n"
                    "target_latency_ms = 1234.5\nenabled = false\n")
    for key in [k for k in __import__("os").environ
                if k.startswith("DTPU_") and k != "DTPU_LOG"]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("DTPU_CONFIG_PATH", str(toml))
    monkeypatch.setenv("DTPU_OVERLOAD_QUEUE_DEPTH", "8")
    monkeypatch.setenv("DTPU_OVERLOAD_BREAKER_COOLDOWN_S", "2.5")
    t = tconfig.RuntimeConfig.from_settings().overload
    j = jconfig.RuntimeConfig.from_settings().overload
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.queue_depth, t.target_latency_ms, t.enabled,
            t.breaker_cooldown_s) == (8, 1234.5, False, 2.5)
    assert dataclasses.asdict(tov.OverloadConfig()) == \
        dataclasses.asdict(jov.OverloadConfig())


# -- the fronts ----------------------------------------------------------------

class GatedEngine(AsyncEngine):
    """Yields one item, then waits for the gate, then finishes."""

    def __init__(self):
        self.gate = asyncio.Event()

    async def generate(self, request, context):
        yield {"token_ids": [5]}
        await self.gate.wait()
        yield {"token_ids": [6], "finish_reason": "length"}


def _call_h(port, body, headers=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Retry-After"),
                resp.getheader("X-Overload-Brownout"),
                json.loads(resp.read()))
    finally:
        conn.close()


@async_test(timeout=120)
async def test_fronts_shed_with_the_reference_bodies_and_headers():
    engine = GatedEngine()
    jp, tp = pipelines(engine)
    cfg = dict(initial_concurrency=1, max_concurrency=1, queue_depth=0,
               batch_shed_level=1, seed=3)
    runtime = await JRuntime.detached(jconfig.RuntimeConfig())
    jm, tm = jdisc.ModelManager(), tdisc.ModelManager()
    jm.models[MODEL] = _j_served(jp)
    tm.models[MODEL] = _t_served(tp)
    jsvc = JHttpService(runtime, jm, host="127.0.0.1", port=0,
                        overload=jov.AdaptiveLimiter(jov.OverloadConfig(**cfg)))
    tsvc = THttpService(tm, host="127.0.0.1", port=0,
                        overload=tov.AdaptiveLimiter(tov.OverloadConfig(**cfg)))
    await jsvc.start()
    await tsvc.start()
    try:
        held = [asyncio.create_task(asyncio.to_thread(
            _call_h, port, chat(max_tokens=2)))
            for port in (jsvc.port, tsvc.port)]
        for svc in (jsvc, tsvc):
            for _ in range(TIMEOUT_S * 20):
                if svc.overload.inflight:
                    break
                await asyncio.sleep(0.05)
            assert svc.overload.inflight == 1
        for headers in ({}, {"x-priority": "batch"},
                        {"x-priority": "urgent"},
                        {"x-request-deadline-ms": "-5"}):
            j = await asyncio.to_thread(_call_h, jsvc.port, chat(), headers)
            t = await asyncio.to_thread(_call_h, tsvc.port, chat(), headers)
            assert t == j, headers
            assert j[0] in (400, 429, 503)
        engine.gate.set()
        j, t = [await h for h in held]
        assert j[0] == t[0] == 200 and j[2] == t[2] == "1"
    finally:
        engine.gate.set()
        await tsvc.stop()
        await jsvc.stop()
        await runtime.close()


async def _jax_worker(url, handler):
    w_rt = await JRuntime.from_settings(
        jconfig.RuntimeConfig(coordinator_url=url, lease_ttl_s=2.0))
    ep = w_rt.namespace("dynamo").component("tpu").endpoint("generate")
    server = await ep.serve_endpoint(handler, graceful_shutdown=False)
    await j_register_llm(w_rt, ep, MODEL, j_test_tokenizer(),
                         context_length=256)
    return w_rt, server


@async_test(timeout=120)
async def test_port_front_types_a_jax_workers_sheds():
    calls = []

    async def handler(request, context):
        calls.append(1)
        if len(calls) % 2:
            raise jerrors.RateLimitedError("deadline infeasible")
        raise jerrors.OverloadedError("projected TTFT 9000 ms")
        yield  # pragma: no cover

    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    w_rt, server = await _jax_worker(coord.url, handler)
    f_rt = await DistributedRuntime.from_settings(
        tconfig.RuntimeConfig(coordinator_url=coord.url, lease_ttl_s=2.0))
    service, watcher = await launch.start_front(f_rt, "127.0.0.1", 0)
    try:
        for _ in range(TIMEOUT_S * 20):
            if watcher.manager.get(MODEL) is not None:
                break
            await asyncio.sleep(0.05)
        seen = {}
        for _ in range(4):
            status, retry, _, out = await asyncio.to_thread(
                _call_h, service.port, chat())
            assert retry is not None and int(retry) >= 1
            seen[status] = out["error"]
        assert set(seen) == {429, 503}
        assert seen[429]["type"] == "rate_limited"
        assert seen[429]["message"] == "deadline infeasible"
        assert seen[503]["type"] == "overloaded"
        assert seen[503]["message"] == "projected TTFT 9000 ms"
        assert terrors.RateLimitedError.WIRE_PREFIX == \
            jerrors.RateLimitedError.WIRE_PREFIX
        exc = terrors.error_from_wire(
            jerrors.RoleTransitionError.WIRE_PREFIX + "stale epoch")
        assert type(exc) is terrors.RoleTransitionError
        assert str(exc) == "stale epoch"
    finally:
        await service.stop()
        await watcher.stop()
        await f_rt.close()
        await server.shutdown()
        await w_rt.close()
        await coord.stop()


@async_test(timeout=120)
async def test_port_client_breaker_opens_on_a_stalled_jax_worker():
    stall = {"on": True, "calls": 0}

    async def handler(request, context):
        stall["calls"] += 1
        if stall["on"]:
            await asyncio.sleep(60)
        yield {"token_ids": [7], "finish_reason": "length"}

    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    w_rt, server = await _jax_worker(coord.url, handler)
    cfg = tconfig.RuntimeConfig(coordinator_url=coord.url, lease_ttl_s=2.0,
                                stream_idle_timeout_s=1.0)
    cfg.overload = tov.OverloadConfig(breaker_failures=2,
                                      breaker_cooldown_s=0.5)
    c_rt = await DistributedRuntime.from_settings(cfg)
    client = await (c_rt.namespace("dynamo").component("tpu")
                    .endpoint("generate").client())
    try:
        await client.wait_for_instances(TIMEOUT_S)
        (wid,) = client.instance_ids()

        async def one():
            stream = await client.generate({"token_ids": [1]})
            return [item async for item in stream]

        for _ in range(2):
            with pytest.raises(terrors.StreamIncompleteError):
                await one()
        assert client.breakers.state(wid) == tov.OPEN
        calls = stall["calls"]
        with pytest.raises(terrors.OverloadedError, match="circuit-open"):
            await one()
        assert stall["calls"] == calls  # no dispatch while open
        stall["on"] = False
        await asyncio.sleep(0.6)  # past the cooldown: a half-open probe
        assert await one() == [{"token_ids": [7], "finish_reason": "length"}]
        assert client.breakers.state(wid) == tov.CLOSED
    finally:
        await client.close()
        await c_rt.close()
        await server.shutdown()
        await w_rt.close()
        await coord.stop()
