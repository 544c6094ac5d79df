"""Standby workers and the fleet scaler in the port
(``dynamo_tpu_torch.llm.standby``, ``planner/capacity.py``, the status
server's ``/control/scale`` and ``backends.gpu --standby``) against the
JAX package's.

- The same demand, pressure and queue-depth sequences under a fake clock
  through both packages' ``CapacityModel`` and ``FleetScaler`` give the
  same targets, decision records, journal refs and coordinator bytes.
- A parked standby (both packages) announces itself, registers nothing,
  joins on a promote directive, fences replays and retires through the
  role manager's drain; the same verbs give the same statuses.
- The GPU worker runs ``--standby`` as a process: parked with no card,
  promoted by the port's FleetScaler, serving, retired to exit 0.
Everything runs on the CPU at tiny-test or mocker scale.
"""

import asyncio
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
from conftest import async_test

from dynamo_tpu.llm import reconfig as jreconfig
from dynamo_tpu.llm import standby as jstandby
from dynamo_tpu.llm.mocker import MockerConfig as JMockerConfig
from dynamo_tpu.llm.mocker import MockerEngine as JMockerEngine
from dynamo_tpu.planner import capacity as jcapacity
from dynamo_tpu.planner.connector import FakeConnector as JFakeConnector
from dynamo_tpu.runtime import journal as jjournal
from dynamo_tpu.runtime.config import RuntimeConfig as JRuntimeConfig
from dynamo_tpu.runtime.distributed import \
    DistributedRuntime as JDistributedRuntime
from dynamo_tpu.runtime.metrics import MetricsRegistry as JMetricsRegistry
from dynamo_tpu.runtime.slo import SloPressure as JSloPressure
from dynamo_tpu_torch.llm import reconfig as treconfig
from dynamo_tpu_torch.llm import standby as tstandby
from dynamo_tpu_torch.llm.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.planner import capacity as tcapacity
from dynamo_tpu_torch.planner.connector import FakeConnector
from dynamo_tpu_torch.runtime import journal as tjournal
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.coordinator import Coordinator
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.msgpack_lite import packb
from dynamo_tpu_torch.runtime.slo import SloPressure

NS = "autoscale"
FAST = dict(prefill_tokens_per_s=1e7, decode_step_s=0.0005)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(capacity=jcapacity, standby=jstandby,
                      reconfig=jreconfig, journal=jjournal,
                      pressure=JSloPressure, connector=JFakeConnector,
                      runtime=JDistributedRuntime, config=JRuntimeConfig,
                      mocker=(JMockerConfig, JMockerEngine),
                      registry=JMetricsRegistry)
PORT = SimpleNamespace(capacity=tcapacity, standby=tstandby,
                       reconfig=treconfig, journal=tjournal,
                       pressure=SloPressure, connector=FakeConnector,
                       runtime=DistributedRuntime, config=RuntimeConfig,
                       mocker=(MockerConfig, MockerEngine),
                       registry=MetricsRegistry)


async def wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        await asyncio.sleep(interval)
    raise AssertionError(f"condition not reached in {timeout}s")


def fresh_journal(pk, worker="planner"):
    pk.journal._JOURNAL = pk.journal.Journal(capacity=8192, worker=worker)
    return pk.journal._JOURNAL


def strip_ts(value):
    if isinstance(value, dict):
        return {k: strip_ts(v) for k, v in value.items() if k != "ts"}
    if isinstance(value, list):
        return [strip_ts(v) for v in value]
    return value


# ---------------------------------------------------------------------------
# the capacity model and the scaler, both packages on the same signals
# ---------------------------------------------------------------------------

MODEL_STEPS = [
    # (active, waiting, queue, current, pressure level, depth, roofline,
    #  expected)
    (20, 4, 0, 3, 0, 0, None, None),
    (20, 4, 16, 3, 0, 0, None, None),
    (1, 0, 0, 3, 2, 0, None, None),
    (1, 0, 0, 3, 0, 9, None, None),
    (20, 4, 0, 3, 0, 0, 0.17, 0.34),
    (20, 4, 0, 3, 0, 0, 0.01, 0.34),
    (500, 0, 0, 3, 0, 0, None, None),
    (0, 0, 0, 3, 0, 0, None, None),
    (7, 3, None, 2, None, None, None, None),
]


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_capacity_model_targets_match_reference(alpha):
    kw = dict(min_workers=1, max_workers=8, slots_per_worker=10,
              target_utilization=0.8, pressure_level=2, queue_depth_high=8)
    port = tcapacity.CapacityModel(tcapacity.CapacityConfig(**kw), alpha)
    ref = jcapacity.CapacityModel(jcapacity.CapacityConfig(**kw), alpha)
    got = []
    for a, w, q, cur, lvl, depth, frac, exp in MODEL_STEPS:
        row = []
        for m in (port, ref):
            d = m.observe(a, w, q)
            row.append((d, m.target(cur, lvl, depth, roofline_frac=frac,
                                    expected_frac=exp),
                        m.worker_capacity(frac, exp), m.demand))
        assert row[0] == row[1], (a, w, q, row)
        got.append(row[0][1])
    if alpha == 1.0:
        assert got[:8] == [3, 5, 4, 4, 6, 6, 8, 1]


def test_capacity_env_knobs_match_reference(monkeypatch):
    monkeypatch.setenv("DTPU_PLANNER_CAPACITY_COOLDOWN_S", "7.5")
    monkeypatch.setenv("DTPU_PLANNER_CAPACITY_MAX_WORKERS", "12")
    monkeypatch.setenv("DTPU_PLANNER_CAPACITY_ENABLED", "1")
    port = tcapacity.apply_capacity_env(tcapacity.CapacityConfig())
    ref = jcapacity.apply_capacity_env(jcapacity.CapacityConfig())
    assert (port.cooldown_s, port.max_workers, port.enabled) == \
        (7.5, 12, True)
    assert {k: v for k, v in vars(port).items() if k != "component"} == \
        {k: v for k, v in vars(ref).items() if k != "component"}
    # The port's workers serve component "gpu"; the reference's "tpu".
    assert (port.component, ref.component) == ("gpu", "tpu")


class FakeCoord:
    def __init__(self):
        self.kv = {}

    async def kv_get_prefix(self, prefix):
        return [{"k": k, "v": v} for k, v in sorted(self.kv.items())
                if k.startswith(prefix)]

    async def kv_put(self, key, value, lease_id=None,
                     use_primary_lease=False):
        self.kv[key] = value

    async def kv_delete(self, key):
        return self.kv.pop(key, None) is not None


def S(worker, role="decode", state="serving", epoch=0, inflight=0):
    return {"worker": worker, "role": role, "state": state, "epoch": epoch,
            "inflight": inflight, "ts": 1000.0}


# name: (statuses, standbys, {extra kv}, [(pressure, demand, depth,
#        perf)], config, clock steps, apply issued directives?)
SCALER_SCRIPTS = {
    "hysteresis_then_promote": (
        [S("aa", inflight=3)], ["bb"], {},
        [((2, ("ttft",)), (4, 6), None, None)] * 2,
        {"slots_per_worker": 4}, [0, 0], False),
    "cooldown_then_in_flight": (
        [S("aa")], ["bb", "cc"], {},
        [((2, ("ttft",)), (9, 9), None, None)] * 3,
        {"slots_per_worker": 4, "hysteresis_intervals": 1,
         "cooldown_s": 30.0}, [0, 10, 40], True),
    "scale_in_least_loaded": (
        [S("aa", inflight=9), S("bb", inflight=1), S("cc", inflight=4)],
        [], {}, [((0, ()), (0, 0), None, None)] * 2,
        {"hysteresis_intervals": 1, "min_workers": 1}, [0, 100], True),
    "floor_single_worker": (
        [S("aa")], [], {}, [((0, ()), (0, 0), None, None)],
        {"hysteresis_intervals": 1, "min_workers": 1}, [0], False),
    "cold_path_connector": (
        [S("aa")], [], {}, [((2, ("ttft",)), (9, 9), None, None)],
        {"slots_per_worker": 4, "hysteresis_intervals": 1}, [0], False),
    "orphaned_promote_replaced": (
        [S("aa")], ["cc"],
        {f"scale/{NS}/bb": {"action": "promote", "role": "decode",
                            "epoch": 5, "ts": 1000.0}},
        [((2, ("ttft",)), (9, 9), None, None)],
        {"slots_per_worker": 4, "hysteresis_intervals": 1}, [0], False),
    "queue_and_derate": (
        [S("aa"), S("bb")], ["cc"], {},
        [(None, (10, 2), 12, {"roofline_frac": 0.1,
                              "expected_frac": 0.3})] * 2,
        {"slots_per_worker": 8, "hysteresis_intervals": 2}, [0, 0], False),
    "draining_blocks": (
        [S("aa"), S("zz", state="draining", epoch=2)], ["bb"], {},
        [((3, ("ttft", "itl")), (9, 9), None, None)],
        {"slots_per_worker": 4, "hysteresis_intervals": 1}, [0], False),
}


async def run_scaler(pk, script, monkeypatch) -> tuple:
    statuses, standbys, extra, signals, cfg_kw, steps, apply = \
        SCALER_SCRIPTS[script]
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    fresh_journal(pk)
    fire = pk.journal.emit(pk.journal.EventKind.SLO_ALERT_FIRE,
                           objective="ttft", severity="page")
    fake = FakeCoord()
    for s in statuses:
        fake.kv[f"rolestatus/{NS}/{s['worker']}"] = dict(s)
    for w in standbys:
        fake.kv[f"standby/{NS}/{w}"] = {"worker": w, "state": "ready",
                                        "ts": 1000.0}
    fake.kv.update({k: dict(v) for k, v in extra.items()})
    now = [100.0]
    state = {"signal": signals[0]}

    def pressure():
        p = state["signal"][0]
        return None if p is None else pk.pressure(
            level=p[0], worst_burn=20.0, failing=tuple(p[1]))

    connector = pk.connector({"gpu": 1})
    metrics = pk.registry()
    cfg = pk.capacity.CapacityConfig(enabled=True, component="gpu", **{
        "hysteresis_intervals": 2, "cooldown_s": 60.0, **cfg_kw})
    sc = pk.capacity.FleetScaler(
        fake, NS, cfg, connector=connector, pressure_fn=pressure,
        queue_depth_fn=lambda: state["signal"][2],
        demand_fn=lambda: state["signal"][1],
        perf_fn=lambda: state["signal"][3], clock=lambda: now[0],
        metrics=metrics)
    records = []
    for signal, dt in zip(signals, steps):
        now[0] += dt
        state["signal"] = signal
        records.append(await sc.step())
        if apply:
            # The issued directive applies: a promoted standby serves, a
            # retired worker goes; the directive is reaped.
            for k, v in list(fake.kv.items()):
                if not k.startswith(f"scale/{NS}/"):
                    continue
                w = k.rsplit("/", 1)[-1]
                del fake.kv[k]
                if v["action"] == "promote":
                    fake.kv.pop(f"standby/{NS}/{w}", None)
                    fake.kv[f"rolestatus/{NS}/{w}"] = S(w,
                                                        epoch=v["epoch"])
                else:
                    fake.kv.pop(f"rolestatus/{NS}/{w}", None)
    events = [(e["kind"], e["ref"], e.get("cause"), e["attrs"])
              for e in pk.journal.get_journal().events()]
    series = sorted(line for line in metrics.expose().decode().splitlines()
                    if "autoscale" in line and not line.startswith("#")
                    and "_created" not in line)
    return (records, packb(sorted(fake.kv.items())), events, sc.issued,
            connector.calls, series, fire)


@pytest.mark.parametrize("script", sorted(SCALER_SCRIPTS))
@async_test
async def test_fleet_scaler_decisions_match_reference(script, monkeypatch):
    port = await run_scaler(PORT, script, monkeypatch)
    ref = await run_scaler(JAX, script, monkeypatch)
    names = ("records", "coordinator bytes", "journal", "issued",
             "connector calls", "autoscale series", "alert ref")
    for name, a, b in zip(names, port, ref):
        assert a == b, name


def test_scale_keys_match_reference():
    assert (tstandby.standby_key(NS, 0xcafe), tstandby.scale_key(
        NS, 0xcafe)) == (jstandby.standby_key(NS, 0xcafe),
                         jstandby.scale_key(NS, 0xcafe))
    assert tstandby.SCALE_ACTIONS == jstandby.SCALE_ACTIONS
    assert vars(tstandby.StandbyState).keys() == \
        vars(jstandby.StandbyState).keys()


# ---------------------------------------------------------------------------
# the scale agent over a coordinator, both packages
# ---------------------------------------------------------------------------

async def start_worker(pk, url, standby=False):
    Config, Engine = pk.mocker
    rt = await pk.runtime.from_settings(pk.config(
        coordinator_url=url, lease_ttl_s=1.0, namespace=NS))
    engine = Engine(Config(**FAST))

    async def build(r):
        prof = pk.reconfig.ServingProfile(r)
        ep = rt.namespace(NS).component("mocker").endpoint("generate")
        return prof.add_server(await ep.serve_endpoint(
            engine.handler(), graceful_shutdown=False))

    w = SimpleNamespace(rt=rt, engine=engine, hex=f"{rt.instance_id:x}",
                        shutdowns=0)
    w.mgr = pk.reconfig.RoleManager(rt, build, role="decode", drain_s=0.2)

    def on_shutdown():
        w.shutdowns += 1
    w.agent = pk.standby.ScaleAgent(rt, w.mgr, standby=standby,
                                    on_shutdown=on_shutdown,
                                    metrics=rt.metrics)
    if not standby:
        await w.mgr.start()
    await w.agent.start()
    engine.start()
    return w


async def stop_worker(w) -> None:
    await w.engine.stop()
    await w.agent.stop()
    await w.mgr.stop()
    await w.rt.close()


async def standby_lifecycle(pk, coordinator_cls) -> list:
    """Park, promote by directive, replay the promote, retire: the statuses
    and keys each step leaves (worker ids and times dropped)."""
    fresh_journal(pk, "w")
    coord = coordinator_cls("127.0.0.1", 0)
    await coord.start()
    url = f"tcp://127.0.0.1:{coord.port}"
    w = await start_worker(pk, url, standby=True)
    client = w.rt.require_coordinator()
    seen = []

    async def view(label):
        keys = []
        for prefix in ("standby/", "instances/", "rolestatus/"):
            keys += [i["k"].replace(w.hex, "W")
                     for i in await client.kv_get_prefix(prefix)]
        seen.append((label, keys, strip_ts(
            {k: v for k, v in w.agent.standby_status().items()
             if k != "worker"}), w.mgr.role, w.mgr.applied_epoch))
    try:
        await view("parked")
        await client.kv_put(pk.standby.scale_key(NS, w.rt.instance_id),
                            {"action": "promote", "role": "agg",
                             "epoch": 3, "cause": "planner#9",
                             "issued_by": "planner"})
        await wait_for(lambda: w.agent.state == "active")
        await view("promoted")
        await client.kv_put(pk.standby.scale_key(NS, w.rt.instance_id),
                            {"action": "promote", "role": "agg",
                             "epoch": 3, "issued_by": "planner"})
        await asyncio.sleep(0.2)
        assert w.agent.promotions == 1
        await view("replayed")
        await client.kv_put(pk.standby.scale_key(NS, w.rt.instance_id),
                            {"action": "retire", "epoch": 4,
                             "issued_by": "planner"})
        await wait_for(lambda: w.shutdowns == 1)
        await view("retired")
        kinds = [(e["kind"], e.get("cause")) for e in
                 pk.journal.get_journal().events()]
        seen.append(("journal", [k for k, _ in kinds]))
    finally:
        await stop_worker(w)
        await coord.stop()
    return seen


@async_test
async def test_standby_lifecycle_matches_reference():
    from dynamo_tpu.runtime.coordinator import Coordinator as JCoordinator
    port = await standby_lifecycle(PORT, Coordinator)
    ref = await standby_lifecycle(JAX, JCoordinator)
    assert port == ref
    parked = port[0]
    assert parked[1] == [f"standby/{NS}/W"] and parked[2]["state"] == "ready"
    assert port[1][1] == [f"instances/{NS}/mocker/generate/W",
                          f"rolestatus/{NS}/W"]


async def scale_verb_bodies(pk, health, coordinator_cls) -> list:
    import json
    import urllib.request
    fresh_journal(pk, "w")
    coord = coordinator_cls("127.0.0.1", 0)
    await coord.start()
    w = await start_worker(pk, f"tcp://127.0.0.1:{coord.port}", standby=True)
    server = health.SystemStatusServer(w.rt, host="127.0.0.1", port=0,
                                       role_manager=w.mgr,
                                       scale_agent=w.agent)
    await server.start()
    loop = asyncio.get_running_loop()

    def call(method, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/control/scale", data=data,
            method=method)
        try:
            with urllib.request.urlopen(req) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())
    try:
        out = []
        for method, body in (
                ("GET", None),
                ("POST", {"action": "promote", "role": "decode",
                          "epoch": 1}),
                ("POST", {"action": "promote", "role": "decode",
                          "epoch": 1}),
                ("POST", {"action": "grow"}),
                ("POST", {"action": "retire", "epoch": 2}),
                ("POST", {"action": "retire", "epoch": 3})):
            status, payload = await loop.run_in_executor(
                None, call, method, body)
            out.append((status, strip_ts({k: v for k, v in payload.items()
                                          if k != "worker"})))
        out.append((w.agent.promotions, w.shutdowns, w.mgr.state))
        return out
    finally:
        await server.stop()
        await stop_worker(w)
        await coord.stop()


@async_test
async def test_status_server_scale_verb_matches_reference():
    from dynamo_tpu.runtime import health as jhealth
    from dynamo_tpu.runtime.coordinator import Coordinator as JCoordinator
    from dynamo_tpu_torch.runtime import health as thealth
    port = await scale_verb_bodies(PORT, thealth, Coordinator)
    ref = await scale_verb_bodies(JAX, jhealth, JCoordinator)
    assert port == ref
    assert [s for s, _ in port[:-1]] == [200, 200, 200, 400, 200, 409]
    assert port[-1] == (1, 1, "retired")


@async_test
async def test_standby_and_role_series_match_reference():
    """The standby_*, worker_role and role_flips_total series of one
    promote and one flip, exposed by both packages' registries."""
    from prometheus_client.parser import text_string_to_metric_families

    async def series(pk):
        fresh_journal(pk, "w")
        reg = pk.registry()
        coord = SimpleNamespace(kv_delete=_noop_args, kv_put=_noop_args)
        rt = SimpleNamespace(config=SimpleNamespace(namespace=NS,
                                                    retire_drain_s=0.1),
                             has_discovery=False, instance_id=0xab,
                             metrics=reg, shutdown=lambda: None,
                             require_coordinator=lambda: coord)

        async def build(r):
            return pk.reconfig.ServingProfile(r)
        mgr = pk.reconfig.RoleManager(rt, build, role="decode")
        agent = pk.standby.ScaleAgent(rt, mgr, standby=True, metrics=reg)
        agent._write_standby = _noop
        await agent.start()
        await agent._promote({"action": "promote", "role": "decode",
                              "epoch": 1})
        await mgr.set_role("prefill", 2)
        with pytest.raises(Exception):
            await mgr.set_role("agg", 1)
        out = {}
        for fam in text_string_to_metric_families(reg.expose().decode()):
            for s in fam.samples:
                if s.name.endswith("_created") or "seconds" in s.name:
                    continue
                if fam.name.startswith(("dynamo_tpu_standby",
                                        "dynamo_tpu_worker_role",
                                        "dynamo_tpu_role_flips")):
                    out[(s.name, tuple(sorted(s.labels.items())))] = s.value
        return out

    port, ref = await series(PORT), await series(JAX)
    assert port == ref and port


async def _noop():
    return None


async def _noop_args(*_args, **_kwargs):
    return None


# ---------------------------------------------------------------------------
# the GPU worker's --standby as a process
# ---------------------------------------------------------------------------

def _read_until(proc, text, timeout=90.0) -> str:
    import queue
    import threading
    if not hasattr(proc, "lines"):
        proc.lines, proc.seen = queue.Queue(), []
        threading.Thread(target=lambda: [proc.lines.put(x)
                                         for x in proc.stdout],
                         daemon=True).start()
    deadline = time.monotonic() + timeout
    while not any(text in x for x in proc.seen):
        assert time.monotonic() < deadline, proc.seen[-20:]
        try:
            proc.seen.append(proc.lines.get(timeout=0.5))
        except queue.Empty:
            assert proc.poll() is None, proc.seen[-20:]
    return next(x for x in proc.seen if text in x)


@async_test(timeout=180)
async def test_gpu_worker_standby_promote_serve_retire():
    """``backends.gpu --standby``: parked on standby/ with no model card
    and no endpoint; the port's FleetScaler promotes it (it registers and
    answers), then retires it: it drains, exits 0 and prints its exit
    counters with its role and standby state."""
    coord = Coordinator("127.0.0.1", 0)
    await coord.start()
    url = f"tcp://127.0.0.1:{coord.port}"
    rt = await DistributedRuntime.from_settings(RuntimeConfig(
        coordinator_url=url))
    client = rt.require_coordinator()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.backends.gpu", "--standby",
         "--model", "tiny-test", "--device", "cpu", "--num-pages", "64",
         "--no-kv-plane", "--coordinator-url", url], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    loop = asyncio.get_running_loop()
    try:
        ready = await loop.run_in_executor(None, _read_until, proc,
                                           "GPU_WORKER_READY")
        assert "mode=standby port=0" in ready, ready
        hexid = ready.split("worker=", 1)[1].split()[0]
        scaler = tcapacity.FleetScaler(client, rt.config.namespace)
        assert [s["worker"] for s in await scaler.standbys()] == [hexid]
        assert not await client.kv_get_prefix("models/")
        assert not await client.kv_get_prefix("instances/")
        epoch = scaler._next_epoch(await scaler.fleet(),
                                   await scaler.pending(),
                                   await scaler.role_directives())
        await scaler.issue(hexid, "promote", "agg", epoch)
        deadline = time.monotonic() + 30
        while not await client.kv_get_prefix("models/"):
            assert time.monotonic() < deadline
            await asyncio.sleep(0.05)
        ep = rt.namespace().component("gpu").endpoint("generate")
        gen = await ep.client()
        await gen.wait_for_instances(10)
        wire = {"model": "tiny-test", "token_ids": list(range(3, 30)),
                "stop_conditions": {"max_tokens": 4, "ignore_eos": True},
                "sampling_options": {}}
        got = [t for item in [x async for x in await gen.generate(wire)]
               for t in item.get("token_ids", [])]
        assert len(got) == 4
        await gen.close()
        assert not await scaler.standbys()
        await scaler.issue(hexid, "retire", None, epoch + 1)
        code = await loop.run_in_executor(None, proc.wait, 60)
        exit_line = await loop.run_in_executor(None, _read_until, proc,
                                               "GPU_WORKER_EXIT", 30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        await rt.close()
        await coord.stop()
    import json
    counters = json.loads(exit_line.split(" ", 1)[1])
    assert code == 0
    assert counters["role"]["state"] == "retired"
    assert counters["scale"]["state"] == "retired"
    assert counters["scale"]["promotions"] == 1
    assert counters["engine"]["windows"] >= 1
