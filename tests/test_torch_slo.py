"""The port's SLO plane (``dynamo_tpu_torch.runtime.slo``), request log
(``llm/recorder.py``'s JSONL sink) and ``/debug/slo`` against the JAX
package's, on the CPU.

- The same TTFT / ITL / outcome streams under a fake clock, through both
  packages' ``SloPlane`` with the same targets: equal burn rates, alert
  states, page counts, ``pressure()`` and ``snapshot()`` at every
  checkpoint, and the same page callbacks in the same order. Exact: the
  same integer buckets and float arithmetic.
- ``[slo]`` TOML under ``DTPU_SLO_*`` env layers into the same settings.
- The request log: the port ledger's JSONL lines carry the reference's
  keys and statuses, and ``finish_account`` feeds availability and
  goodput as the reference's does.
- A fast-burn page on a plane wired as the worker wires it
  (``launch.init_observability``) writes a flight bundle and journals
  ``slo_alert_fire``.
- ``/debug/slo`` on the port's status server and on its front answers 200
  with the body of the reference's ``SloPlane.snapshot()`` for the same
  observations.
"""

import asyncio
import dataclasses
import json
import os
import time

import pytest
import torch
from conftest import async_test
from test_torch_http import call

from dynamo_tpu.llm import recorder as jrec
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import slo as jslo
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm import recorder as trec
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import flight, journal
from dynamo_tpu_torch.runtime import slo as tslo
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.health import SystemStatusServer
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

torch.set_num_threads(1)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _stream(kind: str):
    """A scripted stream of (dt, event, value) with checkpoints."""
    ev = []
    if kind == "ttft_burn":
        ev += [(10.0, "ttft", 0.01)] * 180 + [("check",)]
        ev += [(10.0, "ttft", 5.0)] * 60 + [("check",)]
        ev += [(10.0, "ttft", 0.01)] * 60 + [("check",)]
        ev += [(10.0, "ttft", 5.0)] * 60 + [("check",)]
    elif kind == "blip":
        ev += [(10.0, "ttft", 0.01)] * 360 + [("check",)]
        ev += [(10.0, "ttft", 5.0)] * 10 + [("check",)]
    elif kind == "itl_and_outcomes":
        for i in range(400):
            ev.append((5.0, "itl", 0.5 if i % 7 == 0 else 0.01))
            ev.append((0.0, "req", ("ok", "shed", "error")[i % 3]
                       if i > 200 else "ok"))
            if i % 50 == 49:
                ev.append(("check",))
    elif kind == "slow_leak":
        # 2% bad for hours: the slow ticket, no fast page.
        for i in range(3000):
            ev.append((60.0, "ttft", 5.0 if i % 50 == 0 else 0.01))
            ev.append((0.0, "req", "error" if i % 40 == 0 else "ok"))
            if i % 500 == 499:
                ev.append(("check",))
    return ev


CONFIGS = {
    "ttft_burn": dict(ttft_p99_ms=100.0, min_events=5),
    "blip": dict(ttft_p99_ms=100.0, min_events=5),
    "itl_and_outcomes": dict(itl_p99_ms=100.0, error_rate=0.01,
                             goodput=0.9, min_events=5),
    "slow_leak": dict(ttft_p99_ms=100.0, error_rate=0.001, min_events=5),
}


def drive(mod, kind):
    clk = FakeClock()
    plane = mod.SloPlane(mod.SloConfig(**CONFIGS[kind]), clock=clk)
    pages = []
    plane.on_page(lambda target, sev: pages.append((target, sev)))
    trace = []
    for item in _stream(kind):
        if item[0] == "check":
            burns = {name: {w: plane.burn_rate(name, s)
                            for w, s in mod.WINDOWS.items()}
                     for name in plane.targets}
            trace.append((plane.snapshot(), plane.pressure().to_wire(),
                          burns, dict(plane.alerts), plane.pages_total,
                          list(pages)))
            continue
        dt, what, value = item
        clk.advance(dt)
        if what == "ttft":
            plane.observe_ttft(value)
        elif what == "itl":
            plane.observe_itl(value)
        else:
            plane.observe_request(ok=value == "ok", shed=value == "shed")
    return trace


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_slo_streams_equal_reference(kind):
    ref = drive(jslo, kind)
    got = drive(tslo, kind)
    assert got == ref
    if kind == "ttft_burn":
        assert ref[-1][4] == 2  # two fast pages, rising edges
    if kind == "blip":
        assert ref[-1][4] == 0
    if kind == "slow_leak":
        assert any(snap["targets"]["ttft"]["alerts"]["slow"]
                   for snap, *_ in ref)


def test_slo_config_layering_and_defaults(tmp_path, monkeypatch):
    for key in [k for k in os.environ
                if k.startswith("DTPU_") and k != "DTPU_LOG"]:
        monkeypatch.delenv(key)
    toml = tmp_path / "rt.toml"
    toml.write_text("[slo]\nttft_p99_ms = 250.0\nfast_burn = 10.0\n"
                    "request_ring = 64\n")
    monkeypatch.setenv("DTPU_CONFIG_PATH", str(toml))
    monkeypatch.setenv("DTPU_SLO_FAST_BURN", "12.5")
    monkeypatch.setenv("DTPU_SLO_REQUEST_LOG_PATH", "/x/requests.jsonl")
    t = tconfig.RuntimeConfig.from_settings().slo
    j = jconfig.RuntimeConfig.from_settings().slo
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.ttft_p99_ms, t.fast_burn, t.request_ring) == (250.0, 12.5, 64)
    assert dataclasses.asdict(tslo.SloConfig()) == \
        dataclasses.asdict(jslo.SloConfig())
    assert tslo.SloConfig().targets() == {}
    assert not tslo.SloPlane(tslo.SloConfig()).enabled


@async_test(timeout=60)
async def test_request_log_lines_carry_the_reference_keys(tmp_path):
    lines = {}
    for name, mod in (("port", trec), ("jax", jrec)):
        path = tmp_path / f"{name}.jsonl"
        ledger = mod.RequestLedger(capacity=8, path=str(path))
        plane = (tslo if mod is trec else jslo).SloPlane(
            (tslo if mod is trec else jslo).SloConfig(error_rate=0.01,
                                                      goodput=0.9))
        for status, http in (("ok", 200), ("shed", 503), ("error", 500),
                             ("cancelled", None)):
            acct = mod.make_account("chat_completions", "m")
            acct["_itls"].extend([0.01, 0.02, 0.5])
            mod.finish_account(acct, status, http_status=http,
                               ledger=ledger, slo_plane=plane)
        await asyncio.sleep(0.05)
        await ledger.close()
        lines[name] = [json.loads(x) for x in path.read_text().splitlines()]
        assert ledger.snapshot()["sink"]["written"] == 4
        lines[name + "_slo"] = {
            t: plane.burn_rate(t, 300)[1] for t in plane.targets}
    assert [set(x) for x in lines["port"]] == [set(x) for x in lines["jax"]]
    assert [x["status"] for x in lines["port"]] == \
        ["ok", "shed", "error", "cancelled"]
    assert [(x["itl_p50_s"], x["itl_p99_s"]) for x in lines["port"]] == \
        [(x["itl_p50_s"], x["itl_p99_s"]) for x in lines["jax"]]
    assert lines["port_slo"] == lines["jax_slo"]


def test_fast_burn_page_writes_a_flight_bundle(tmp_path):
    cfg = tconfig.RuntimeConfig()
    cfg.slo.ttft_p99_ms = 100.0
    cfg.slo.min_events = 5
    metrics = MetricsRegistry()
    saved = (journal.get_journal().worker, flight._bundle_dir,
             flight._cooldown_s)
    launch.init_observability(cfg, metrics, worker="abc")
    flight.configure(bundle_dir=str(tmp_path), cooldown_s=0.0)
    flight._last_trigger_t = -1e18
    clk = FakeClock()
    plane = tslo.get_plane()
    plane._clock = clk
    for series in plane._series.values():
        series._clock = clk
    try:
        for _ in range(60):
            clk.advance(10.0)
            plane.observe_ttft(5.0)
        plane.evaluate()
        assert plane.alerts["ttft"]["fast"]
        for _ in range(200):
            if list(tmp_path.glob("flight-*slo_burn_ttft*.json")):
                break
            time.sleep(0.02)
        assert list(tmp_path.glob("flight-*slo_burn_ttft*.json"))
        kinds = [e["kind"] for e in journal.get_journal().snapshot(64)
                 ["events"]]
        assert "slo_alert_fire" in kinds
        assert "dynamo_tpu_slo_alert_active" in metrics.expose().decode()
    finally:
        tslo.configure(tslo.SloConfig())
        journal.configure(worker=saved[0])
        flight.configure(bundle_dir=saved[1], cooldown_s=saved[2])


@async_test(timeout=60)
async def test_debug_slo_on_the_status_server_and_the_front():
    cfg = tslo.SloConfig(ttft_p99_ms=100.0, itl_p99_ms=50.0, min_events=5)
    plane = tslo.configure(cfg)
    ref = jslo.SloPlane(jslo.SloConfig(**dataclasses.asdict(cfg)))
    for value in (0.01, 0.02, 5.0, 0.03):
        plane.observe_ttft(value)
        ref.observe_ttft(value)
    runtime = await DistributedRuntime.detached(tconfig.RuntimeConfig())
    status = SystemStatusServer(runtime, host="127.0.0.1", port=0)
    front = HttpService(tdisc.ModelManager(), host="127.0.0.1", port=0)
    await status.start()
    await front.start()
    try:
        want = ref.snapshot()
        for port in (status.port, front.port):
            st, _, raw = await call(port, "GET", "/debug/slo")
            assert st == 200
            assert json.loads(raw) == json.loads(json.dumps(want))
        assert want["enabled"] and set(want["targets"]) == {"ttft", "itl"}
    finally:
        await front.stop()
        await status.stop()
        await runtime.close()
        tslo.configure(tslo.SloConfig())
