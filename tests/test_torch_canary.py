"""The port's canary prober (``dynamo_tpu_torch.llm.canary``), the model
watcher's fleet hooks and the task tracker (``runtime/tracker.py``)
against the JAX package's, on the CPU.

- A prober over a scripted manager (per-worker behaviours: ok, wedged,
  garbled, failing), swept the same way with each package's prober and
  breaker board: the same probe outcomes, breaker states, journal chain
  (``canary_fail`` -> ``breaker_transition`` -> ``canary_ok``, each
  ``cause`` the previous event's ref), status body and series.
- Gated joins: ``note_join`` holds the worker on probation (no traffic,
  not even a half-open probe) until its probe passes; the releasing
  ``canary_ok`` is caused by the ``worker_join`` event. ``note_leave``
  forgets the worker.
- The port's ``ModelWatcher`` calls ``on_join`` / ``on_leave`` after its
  ``worker_join`` / ``worker_leave`` events, for a port worker that
  registers and then goes.
- The tracker cases of ``tests/test_wide_components.py``, through both
  packages' ``TaskTracker``.
"""

import asyncio

import pytest
import torch
from conftest import async_test
from test_torch_worker import (MODEL, _port_runtime, port_engine,
                               start_port_worker, wait_for)

from dynamo_tpu.llm import canary as jcanary
from dynamo_tpu.runtime import journal as jjournal
from dynamo_tpu.runtime import overload as jov
from dynamo_tpu.runtime import tracker as jtracker
from dynamo_tpu.runtime.metrics import MetricsRegistry as JMetrics
from dynamo_tpu_torch.llm import canary as tcanary
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm.model_card import deregister_llm
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import journal as tjournal
from dynamo_tpu_torch.runtime import overload as tov
from dynamo_tpu_torch.runtime import tracker as ttracker
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

torch.set_num_threads(1)

PKGS = {"jax": (jcanary, jjournal, jov, JMetrics),
        "port": (tcanary, tjournal, tov, MetricsRegistry)}


class _Tokenizer:
    def encode(self, text):
        return [ord(c) % 32 for c in text][:6]


class _Client:
    """Per-worker scripted behaviours: ok, hang, garble, error."""

    def __init__(self, ov, behaviours):
        self.behaviours = behaviours
        self.breakers = ov.BreakerBoard(ov.OverloadConfig(
            breaker_failures=2, breaker_cooldown_s=60.0))

    def instance_ids(self):
        return sorted(self.behaviours)

    async def direct(self, wire, iid, context=None):
        mode = self.behaviours[iid]

        async def gen():
            if mode == "hang":
                await asyncio.sleep(5)
            if mode == "error":
                raise ConnectionError("boom")
            toks = [9, 9, 8] if mode == "garble" else [1, 2, 3]
            yield {"token_ids": toks[:2], "finish_reason": None}
            yield {"token_ids": toks[2:], "finish_reason": "length"}

        return gen()


class _Served:
    def __init__(self, client):
        self.client = client
        self.entry = type("E", (), {"model_name": MODEL})()
        self.preprocessor = type("P", (), {"tokenizer": _Tokenizer()})()


class _Manager:
    def __init__(self, served):
        self.models = {MODEL: served}


def _mark(journal_mod) -> int:
    return max((e["seq"] for e in journal_mod.get_journal().events()),
               default=-1)


def _since(journal_mod, mark: int) -> list:
    return [e for e in journal_mod.get_journal().events()
            if e["seq"] > mark]


def _chain(events):
    """Journal events with refs replaced by their positions (the worker
    ids and sequence numbers of the two journals differ)."""
    pos = {e["ref"]: i for i, e in enumerate(events)}
    return [(e["kind"], pos.get(e["cause"], e["cause"]),
             {k: v for k, v in e["attrs"].items()
              if k not in ("ttft_ms",)}) for e in events]


async def _sweeps(pkg):
    canary_mod, journal_mod, ov, Metrics = PKGS[pkg]
    journal_mod.configure(worker="w")
    mark = _mark(journal_mod)
    client = _Client(ov, {1: "ok", 2: "hang", 3: "error"})
    metrics = Metrics()
    prober = canary_mod.CanaryProber(
        _Manager(_Served(client)),
        canary_mod.CanaryConfig(enabled=True, timeout_s=0.2, max_tokens=3),
        metrics=metrics.namespace("x"))
    trace = []
    for step in range(5):
        if step == 2:
            client.behaviours[2] = "ok"
        if step == 3:
            client.behaviours[2] = "garble"
            client.behaviours[3] = "ok"
        n = await prober.sweep()
        trace.append((n, [client.breakers.state(w) for w in (1, 2, 3)],
                      {w: (s["last_outcome"], s["probes"], s["ok"],
                           s["fail"], s.get("consecutive_fails"))
                       for w, s in prober.status()["workers"].items()}))
    events = _since(journal_mod, mark)
    expo = sorted(line for line in metrics.expose().decode().splitlines()
                  if "canary_probes_total{" in line)
    return trace, _chain(events), expo, prober._expected


@pytest.fixture
def journal_workers():
    """The two journals' worker ids, put back after a test sets them."""
    saved = (jjournal.get_journal().worker, tjournal.get_journal().worker)
    yield
    jjournal.configure(worker=saved[0])
    tjournal.configure(worker=saved[1])


@async_test(timeout=60)
async def test_prober_equals_reference(journal_workers):
    ref = await _sweeps("jax")
    got = await _sweeps("port")
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    assert got[3] == ref[3] == {MODEL: [1, 2, 3]}
    kinds = [k for k, _, _ in ref[1]]
    assert {"canary_fail", "canary_ok", "breaker_transition"} <= set(kinds)


async def _gated(pkg):
    canary_mod, journal_mod, ov, Metrics = PKGS[pkg]
    journal_mod.configure(worker="w")
    mark = _mark(journal_mod)
    client = _Client(ov, {1: "ok", 7: "hang"})
    served = _Served(client)
    prober = canary_mod.CanaryProber(
        _Manager(served), canary_mod.CanaryConfig(
            enabled=True, timeout_s=0.2, max_tokens=3, gate_joins=True))
    trace = []
    for iid in (7, 1):
        journal_mod.emit(journal_mod.EventKind.WORKER_JOIN, model=MODEL,
                         instance=f"{iid:x}")
        prober.note_join(served, iid)
        trace.append(("join", iid, client.breakers.admitted([1, 7])))
        await asyncio.gather(*prober._gate_tasks)
        trace.append(("probed", iid, client.breakers.admitted([1, 7]),
                      sorted(prober.status()["probation"])))
    client.behaviours[7] = "ok"
    await prober.sweep()
    trace.append(("sweep", client.breakers.admitted([1, 7]),
                  prober.status()["probation"]))
    prober.note_leave(served, 7)
    trace.append(("leave", 7 in prober._fails, prober._probation))
    return trace, _chain(_since(journal_mod, mark))


@async_test(timeout=60)
async def test_gated_joins_equal_reference(journal_workers):
    ref = await _gated("jax")
    got = await _gated("port")
    assert got == ref
    trace, chain = ref
    assert trace[0][2] == [1]          # worker 7 held: no traffic at all
    assert trace[-2][1] == [1, 7]      # its probe passed: admitted
    ok = [c for c in chain if c[0] == "canary_ok"]
    assert ok and any(c[2].get("admitted") for c in ok)


@async_test(timeout=120)
async def test_watcher_calls_the_fleet_hooks():
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    f_rt = await _port_runtime(coord.url)
    manager = tdisc.ModelManager()
    watcher = tdisc.ModelWatcher(f_rt, manager)
    calls = []
    watcher.on_join = lambda served, iid: calls.append(
        ("join", served.name, iid))
    watcher.on_leave = lambda served, iid: calls.append(
        ("leave", served.name, iid))
    await watcher.start()
    engine = port_engine()
    w_rt, server = await start_port_worker(coord.url, engine)
    try:
        await wait_for(lambda: calls)
        assert calls == [("join", MODEL, w_rt.instance_id)]
        await deregister_llm(w_rt, MODEL)
        await wait_for(lambda: len(calls) == 2)
        assert calls[1] == ("leave", MODEL, w_rt.instance_id)
    finally:
        await watcher.stop()
        await server.shutdown()
        engine.stop()
        await w_rt.close()
        await f_rt.close()
        await coord.stop()


# -- the task tracker (tests/test_wide_components.py's cases) -----------------

TRACKERS = {"jax": jtracker, "port": ttracker}


@pytest.mark.parametrize("pkg", sorted(TRACKERS))
@async_test(timeout=30)
async def test_tracker_success_and_failure_counts(pkg):
    mod = TRACKERS[pkg]
    tr = mod.TaskTracker()

    async def ok():
        return 42

    async def boom():
        raise ValueError("nope")

    h1 = tr.spawn("ok", ok)
    assert await h1 == 42
    h2 = tr.spawn("bad", boom, policy=mod.OnError.LOG)
    with pytest.raises(ValueError):
        await h2
    assert tr.succeeded == 1 and tr.failed == 1
    assert h2.record.error.startswith("ValueError")


@pytest.mark.parametrize("pkg", sorted(TRACKERS))
@async_test(timeout=30)
async def test_tracker_retry_policy_recovers(pkg):
    mod = TRACKERS[pkg]
    tr = mod.TaskTracker()
    attempts = {"n": 0}

    async def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise RuntimeError("transient")
        return "done"

    h = tr.spawn("flaky", flaky, policy=mod.OnError.RETRY, max_retries=5,
                 backoff_s=0.001)
    assert await h == "done"
    assert attempts["n"] == 3
    assert tr.retried == 2 and tr.failed == 0


@pytest.mark.parametrize("pkg", sorted(TRACKERS))
@async_test(timeout=30)
async def test_tracker_critical_hook_fires(pkg):
    mod = TRACKERS[pkg]
    fired = []
    tr = mod.TaskTracker(on_critical=lambda name, exc: fired.append(name))

    async def die():
        raise RuntimeError("fatal")

    h = tr.spawn("core", die, policy=mod.OnError.CRITICAL)
    with pytest.raises(RuntimeError):
        await h
    assert fired == ["core"]


@pytest.mark.parametrize("pkg", sorted(TRACKERS))
@async_test(timeout=30)
async def test_tracker_shutdown_cancels(pkg):
    mod = TRACKERS[pkg]
    tr = mod.TaskTracker()

    async def forever():
        await asyncio.sleep(3600)

    tr.spawn("sleeper", forever)
    await asyncio.sleep(0.05)
    assert tr.active_count == 1
    await tr.shutdown()
    assert tr.active_count == 0
    with pytest.raises(RuntimeError):
        tr.spawn("late", forever)
