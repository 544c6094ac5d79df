"""Live role changes in the port (``dynamo_tpu_torch.llm.reconfig``,
``planner/reconfig.py``, the worker's profiles and the status server's
``/control/role``) against the JAX package's.

- The same SetRole sequences (duplicates, stale epochs, no-ops, a flip in
  flight, a retire) through both packages' ``RoleManager`` give the same
  outcomes and status values.
- The same fleets, pressure and queue-depth sequences under a fake clock
  through both packages' ``RoleReconfigurator`` give the same decision
  records, journal refs and coordinator bytes.
- A drain cuts streams with typed ``incomplete:role_flip`` /
  ``incomplete:scale_in`` frames that the front's migration attributes.
- The GPU worker's profiles flip around one engine (no weight reload),
  and a mixed fleet flips both ways: the JAX planner flips a port worker
  and the port's planner a JAX worker over one coordinator.
- A prefill worker publishes its load metrics and digests (a flip to agg
  or decode must not leave it unseen).
Everything runs on the CPU at tiny-test or mocker scale.
"""

import asyncio
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
from conftest import async_test

from dynamo_tpu.llm import reconfig as jreconfig
from dynamo_tpu.llm.mocker import MockerConfig as JMockerConfig
from dynamo_tpu.llm.mocker import MockerEngine as JMockerEngine
from dynamo_tpu.planner import reconfig as jplanner
from dynamo_tpu.runtime import journal as jjournal
from dynamo_tpu.runtime.config import RuntimeConfig as JRuntimeConfig
from dynamo_tpu.runtime.coordinator import Coordinator as JCoordinator
from dynamo_tpu.runtime.distributed import \
    DistributedRuntime as JDistributedRuntime
from dynamo_tpu.runtime.errors import RoleTransitionError as JRoleError
from dynamo_tpu.runtime.slo import SloPressure as JSloPressure
from dynamo_tpu_torch.llm import reconfig as treconfig
from dynamo_tpu_torch.llm.discovery import RouterEngine
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.planner import reconfig as tplanner
from dynamo_tpu_torch.runtime import journal as tjournal
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.coordinator import Coordinator
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.errors import RoleTransitionError
from dynamo_tpu_torch.runtime.msgpack_lite import packb
from dynamo_tpu_torch.runtime.slo import SloPressure

NS = "reconfig"
FAST = dict(prefill_tokens_per_s=1e7, decode_step_s=0.0005)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(reconfig=jreconfig, planner=jplanner, journal=jjournal,
                      error=JRoleError, pressure=JSloPressure)
PORT = SimpleNamespace(reconfig=treconfig, planner=tplanner,
                       journal=tjournal, error=RoleTransitionError,
                       pressure=SloPressure)


async def wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        await asyncio.sleep(interval)
    raise AssertionError(f"condition not reached in {timeout}s")


def fresh_journals(worker: str = "planner") -> None:
    for j in (jjournal, tjournal):
        j._JOURNAL = j.Journal(capacity=8192, worker=worker)


def strip_ts(value):
    """``value`` without its wall-clock ``ts`` fields, at any depth."""
    if isinstance(value, dict):
        return {k: strip_ts(v) for k, v in value.items() if k != "ts"}
    if isinstance(value, list):
        return [strip_ts(v) for v in value]
    return value


# ---------------------------------------------------------------------------
# the RoleManager state machine, both packages on the same verbs
# ---------------------------------------------------------------------------

class FakeServer:
    def __init__(self, log):
        self.log, self._inflight = log, {}

    async def shutdown(self, drain_s=None, reason=None):
        self.log.append(("shutdown", drain_s, reason))


def fake_runtime():
    return SimpleNamespace(config=SimpleNamespace(namespace=NS,
                                                  retire_drain_s=0.25),
                           has_discovery=False, instance_id=0xab)


def manager(pk, role="agg", gate=None):
    """A RoleManager of package ``pk`` over a fake runtime; its profiles
    hold one fake server. ``gate``: {role: asyncio.Event} builds that
    wait (a flip held in flight)."""
    log = []

    async def build(r):
        log.append(("build", r))
        if gate and r in gate:
            await gate[r].wait()
        return pk.reconfig.ServingProfile(r).add_server(FakeServer(log))

    mgr = pk.reconfig.RoleManager(fake_runtime(), build, role=role)
    mgr.retired_hooks = 0

    def on_retired():
        mgr.retired_hooks += 1
    mgr._on_retired = on_retired
    return mgr, log


async def apply_verbs(pk, verbs, role="agg") -> list:
    """Each verb's outcome (``ts`` dropped) or its typed error's text,
    then the final status and the profile log."""
    fresh_journals("w")
    mgr, log = manager(pk, role)
    await mgr.start()
    out = []
    for verb in verbs:
        try:
            if verb[0] == "set":
                res = await mgr.set_role(verb[1], verb[2])
            else:
                res = await mgr.retire(verb[1], cause="planner#1")
            out.append(strip_ts(res))
        except pk.error as exc:
            out.append(("rejected", str(exc)))
    out.append(strip_ts(mgr.status()))
    out.append(log)
    out.append([(e["kind"], strip_ts(e["attrs"]))
                for e in pk.journal.get_journal().events()])
    return out


VERB_SCRIPTS = {
    "flip_duplicate_stale_noop": [("set", "decode", 3), ("set", "decode", 3),
                                  ("set", "prefill", 2), ("set", "decode", 7),
                                  ("set", "training", 8)],
    "flip_chain": [("set", "prefill", 1), ("set", "decode", 2),
                   ("set", "agg", 3), ("set", "agg", 3)],
    "retire_then_fenced": [("set", "prefill", 1), ("retire", 2),
                           ("retire", 2), ("set", "decode", 3),
                           ("retire", 1)],
    "stale_retire": [("set", "decode", 5), ("retire", 4)],
}


@pytest.mark.parametrize("script", sorted(VERB_SCRIPTS))
@async_test
async def test_role_manager_outcomes_match_reference(script):
    verbs = VERB_SCRIPTS[script]
    port = await apply_verbs(PORT, verbs)
    ref = await apply_verbs(JAX, verbs)
    assert port == ref


async def inflight_verbs(pk) -> list:
    """A flip held in flight: its duplicate acks, a conflicting flip and a
    retire reject busy; then the flip lands."""
    fresh_journals("w")
    gate = {"prefill": asyncio.Event()}
    mgr, log = manager(pk, "decode", gate)
    await mgr.start()
    flip = asyncio.ensure_future(mgr.set_role("prefill", 1))
    await wait_for(lambda: mgr.state == pk.reconfig.RoleState.FLIPPING)
    out = [strip_ts(await mgr.set_role("prefill", 1))]
    for verb in (lambda: mgr.set_role("agg", 2), lambda: mgr.retire(2)):
        try:
            out.append(strip_ts(await verb()))
        except pk.error as exc:
            out.append(("rejected", str(exc)))
    gate["prefill"].set()
    out.append(strip_ts(await flip))
    out.append(strip_ts(mgr.status()))
    out.append(log)
    return out


@async_test
async def test_role_manager_flip_in_flight_matches_reference():
    assert await inflight_verbs(PORT) == await inflight_verbs(JAX)


# ---------------------------------------------------------------------------
# the planner's decisions, both packages on the same signals
# ---------------------------------------------------------------------------

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

    def packed(self) -> bytes:
        return packb(sorted(self.kv.items()))


def S(worker, role, state="serving", epoch=0, inflight=0, ts=1000.0):
    return {"worker": worker, "role": role, "state": state, "epoch": epoch,
            "inflight": inflight, "ts": ts}


# name: (fleet, {extra kv}, [(pressure (level, failing) or None, depth)],
#        config overrides, clock steps between decisions)
DECISION_SCRIPTS = {
    "hysteresis_then_least_loaded": (
        [S("aa", "decode", inflight=9), S("bb", "decode", inflight=2),
         S("cc", "decode", inflight=5)], {},
        [((2, ("ttft",)), None)] * 2, {}, [0, 0]),
    "cooldown": (
        [S("aa", "decode"), S("bb", "decode"), S("cc", "decode")], {},
        [((2, ("ttft",)), None)] * 3,
        {"hysteresis_intervals": 1, "cooldown_s": 30.0}, [0, 10, 25]),
    "flip_in_flight_draining": (
        [S("aa", "decode", state="draining"), S("bb", "decode"),
         S("cc", "decode")], {},
        [((2, ("ttft",)), None)], {"hysteresis_intervals": 1}, [0]),
    "flip_in_flight_directive": (
        [S("aa", "decode"), S("bb", "decode")],
        {f"role/{NS}/bb": {"role": "prefill", "epoch": 5}},
        [((2, ("ttft",)), None)], {"hysteresis_intervals": 1}, [0]),
    "floors": (
        [S("aa", "decode"), S("bb", "prefill")], {},
        [((2, ("ttft",)), None), ((2, ("itl",)), None)],
        {"hysteresis_intervals": 1}, [0, 0]),
    "itl_flips_prefill_back": (
        [S("aa", "decode"), S("bb", "prefill", epoch=4), S("cc", "prefill")],
        {}, [((2, ("itl",)), 0)], {"hysteresis_intervals": 1}, [0]),
    "queue_depth_alone": (
        [S("aa", "decode"), S("bb", "decode")], {}, [(None, 9), (None, 0)],
        {"hysteresis_intervals": 1}, [0, 0]),
    "gc_applied_and_orphaned": (
        [S("aa", "decode", epoch=6), S("bb", "decode")],
        {f"role/{NS}/aa": {"role": "decode", "epoch": 6},
         f"role/{NS}/zz": {"role": "prefill", "epoch": 2}},
        [(None, None)], {}, [0]),
    "stuck_flip_ignored": (
        [S("aa", "decode", state="flipping", ts=0.0), S("bb", "decode"),
         S("cc", "decode")], {},
        [((3, ("ttft", "itl")), 9), ((2, ("ttft",)), 9)],
        {"hysteresis_intervals": 1, "stuck_flip_s": 10.0}, [0, 0]),
}


async def run_decisions(pk, script, monkeypatch) -> tuple:
    fleet, extra, signals, cfg_kw, steps = DECISION_SCRIPTS[script]
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    fresh_journals("planner")
    fake = FakeCoord()
    for s in fleet:
        fake.kv[f"rolestatus/{NS}/{s['worker']}"] = dict(s)
    fake.kv.update({k: dict(v) for k, v in extra.items()})
    now = [500.0]
    state = {"signal": signals[0]}

    def pressure():
        p = state["signal"][0]
        return None if p is None else pk.pressure(
            level=p[0], worst_burn=14.5, failing=tuple(p[1]))

    async def depth():
        return state["signal"][1]

    cfg = pk.planner.ReconfigConfig(enabled=True, **{
        "hysteresis_intervals": 2, "cooldown_s": 60.0, **cfg_kw})
    r = pk.planner.RoleReconfigurator(fake, NS, cfg, pressure_fn=pressure,
                                      queue_depth_fn=depth,
                                      clock=lambda: now[0])
    records = []
    for signal, dt in zip(signals, steps):
        now[0] += dt
        state["signal"] = signal
        records.append(await r.step())
        # A flip the planner issued applies before the next step.
        for k, v in list(fake.kv.items()):
            if k.startswith(f"role/{NS}/"):
                worker = k.rsplit("/", 1)[-1]
                st = fake.kv.get(f"rolestatus/{NS}/{worker}")
                if st is not None and "issued_by" in v:
                    fake.kv[f"rolestatus/{NS}/{worker}"] = dict(
                        st, role=v["role"], epoch=v["epoch"])
    events = [(e["kind"], e["ref"], e.get("cause"), e["attrs"])
              for e in pk.journal.get_journal().events()]
    return records, fake.packed(), events, r.issued


@pytest.mark.parametrize("script", sorted(DECISION_SCRIPTS))
@async_test
async def test_reconfigurator_decisions_match_reference(script, monkeypatch):
    port = await run_decisions(PORT, script, monkeypatch)
    ref = await run_decisions(JAX, script, monkeypatch)
    assert port[0] == ref[0]      # decision records
    assert port[1] == ref[1]      # the coordinator's bytes
    assert port[2] == ref[2]      # planner_decision events and refs
    assert port[3] == ref[3]      # directives issued


def test_reconfig_env_knobs_match_reference(monkeypatch):
    monkeypatch.setenv("DTPU_PLANNER_RECONFIG_COOLDOWN_S", "7.5")
    monkeypatch.setenv("DTPU_PLANNER_RECONFIG_MIN_PREFILL", "3")
    monkeypatch.setenv("DTPU_PLANNER_RECONFIG_ENABLED", "1")
    port = tplanner.apply_reconfig_env(tplanner.ReconfigConfig())
    ref = jplanner.apply_reconfig_env(jplanner.ReconfigConfig())
    assert (port.cooldown_s, port.min_prefill, port.enabled) == \
        (7.5, 3, True)
    assert vars(port) == vars(ref)


def test_keys_and_vocabularies_match_reference():
    assert treconfig.ROLES == jreconfig.ROLES
    assert treconfig.FLIP_OUTCOMES == jreconfig.FLIP_OUTCOMES
    assert (treconfig.role_key(NS, 0xbeef), treconfig.role_status_key(
        NS, 0xbeef)) == (jreconfig.role_key(NS, 0xbeef),
                         jreconfig.role_status_key(NS, 0xbeef))
    assert (treconfig.DRAIN_REASON, treconfig.SCALE_IN_REASON) == (
        "role_flip", "scale_in")


# ---------------------------------------------------------------------------
# mocker workers over a coordinator: drains migrate with typed reasons
# ---------------------------------------------------------------------------

async def start_mocker_worker(url, role="decode", drain_s=0.3,
                              **mocker_kwargs):
    rt = await DistributedRuntime.from_settings(RuntimeConfig(
        coordinator_url=url, lease_ttl_s=1.0, namespace=NS))
    engine = MockerEngine(MockerConfig(**{**FAST, **mocker_kwargs}))

    async def build(r):
        prof = treconfig.ServingProfile(r)
        comp = "prefill" if r == "prefill" else "mocker"
        ep = rt.namespace(NS).component(comp).endpoint("generate")
        return prof.add_server(await ep.serve_endpoint(
            engine.handler(), graceful_shutdown=False))

    w = SimpleNamespace(rt=rt, engine=engine, hex=f"{rt.instance_id:x}",
                        shutdowns=0)
    w.mgr = treconfig.RoleManager(rt, build, role=role, drain_s=drain_s)

    def on_retired():
        w.shutdowns += 1
    w.mgr._on_retired = on_retired
    await w.mgr.start()
    engine.start()
    return w


async def stop_mocker_worker(w) -> None:
    await w.engine.stop()
    await w.mgr.stop()
    await w.rt.close()


@pytest.mark.parametrize("verb", ["role_flip", "scale_in"])
@async_test
async def test_drain_migrates_streams_with_the_typed_reason(verb):
    """A stream the drain cuts reaches the front's migration as
    ``incomplete:<reason>``: it migrates to the other worker, delivers
    every token, and the context carries ``migration_reason``."""
    coord = Coordinator("127.0.0.1", 0)
    await coord.start()
    url = f"tcp://127.0.0.1:{coord.port}"
    a = await start_mocker_worker(url, decode_step_s=0.01)
    b = await start_mocker_worker(url, decode_step_s=0.01)
    rt = await DistributedRuntime.from_settings(RuntimeConfig(
        coordinator_url=url, lease_ttl_s=1.0, namespace=NS))
    client = await rt.namespace(NS).component("mocker").endpoint(
        "generate").client()
    try:
        await wait_for(lambda: len(client.instance_ids()) == 2)
        migration = Migration(4, inner=RouterEngine(client))
        req = PreprocessedRequest(model="mock-model",
                                  token_ids=list(range(1, 9)))
        req.stop_conditions.max_tokens = 60
        req.stop_conditions.ignore_eos = True
        ctx, tokens = Context(), []

        async def consume():
            async for out in migration.generate(req, ctx):
                tokens.extend(out.token_ids)

        task = asyncio.ensure_future(consume())
        await wait_for(lambda: a.engine.decoding or b.engine.decoding)
        victim = a if a.engine.decoding else b
        out = (await victim.mgr.set_role("prefill", 1) if verb == "role_flip"
               else await victim.mgr.retire(1))
        assert out["outcome"] == "ok"
        await asyncio.wait_for(task, 30)
        assert len(tokens) == 60
        assert ctx.values["migrations"] >= 1
        assert ctx.values["migration_reason"] == verb
        # Every migration is a stream the victim's drain sent back.
        assert victim.mgr.cut_streams == ctx.values["migrations"]
        assert victim.shutdowns == (verb == "scale_in")
    finally:
        await client.close()
        await rt.close()
        for w in (a, b):
            await stop_mocker_worker(w)
        await coord.stop()


@async_test
async def test_endpoint_server_drain_frame_carries_the_reason():
    """``EndpointServer.shutdown(drain_s, reason)`` kills what outlives
    the drain with ``incomplete:<reason>``, which the client raises as
    ``StreamIncompleteError`` with that reason."""
    from dynamo_tpu_torch.runtime.errors import StreamIncompleteError
    rt = await DistributedRuntime.with_embedded_coordinator(
        RuntimeConfig(namespace=NS))
    started = asyncio.Event()

    async def slow(_request, _ctx):
        started.set()
        yield {"token_ids": [1]}
        await asyncio.sleep(30)
        yield {"token_ids": [2]}

    ep = rt.namespace(NS).component("slow").endpoint("generate")
    server = await ep.serve_endpoint(slow, graceful_shutdown=False)
    client = await ep.client()
    try:
        await client.wait_for_instances(5)
        got = []

        async def consume():
            async for item in await client.generate({"x": 1}):
                got.append(item)

        task = asyncio.ensure_future(consume())
        await asyncio.wait_for(started.wait(), 5)
        await server.shutdown(drain_s=0.1, reason="role_flip")
        with pytest.raises(StreamIncompleteError) as exc:
            await asyncio.wait_for(task, 10)
        assert exc.value.reason == "role_flip" and got
        assert server.cut_streams == 1
    finally:
        await client.close()
        await rt.close()


# ---------------------------------------------------------------------------
# the GPU worker's profiles around one engine; mixed fleets
# ---------------------------------------------------------------------------

def gpu_worker_args(extra=()):
    from dynamo_tpu_torch.backends import gpu
    return gpu.parse_args(["--model", "tiny-test", "--device", "cpu",
                           "--num-pages", "64", "--no-kv-plane",
                           "--migration-limit", "2", *extra])


async def start_gpu_worker(url, role="agg", namespace=NS):
    """A port GPU worker (tiny-test on the CPU) as ``backends.gpu.run``
    wires it: the engine outside, its role profiles through
    ``make_profile_builder``, a RoleManager on the coordinator."""
    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
    args = gpu_worker_args(["--mode", role])
    rt = await DistributedRuntime.from_settings(RuntimeConfig(
        coordinator_url=url, lease_ttl_s=2.0, namespace=namespace))
    cfg = gpu.build_engine_config(args)
    engine = launch.load_engine(cfg, None, 0, start=False)
    engine.start(asyncio.get_running_loop())
    handlers = []
    mgr = treconfig.RoleManager(rt, gpu.make_profile_builder(
        rt, args, engine, make_test_tokenizer(), "tiny-test", None,
        handlers), role=role, drain_s=0.2)
    await mgr.start()
    return SimpleNamespace(rt=rt, engine=engine, mgr=mgr, handlers=handlers,
                           hex=f"{rt.instance_id:x}")


async def stop_gpu_worker(w) -> None:
    await w.mgr.stop()
    w.engine.stop()
    await w.rt.close()


@async_test(timeout=180)
async def test_gpu_worker_flips_profiles_around_one_engine():
    """agg -> prefill -> decode -> agg: each role registers what it
    serves (the model card and the gpu endpoint, or the prefill
    endpoint), the engine and its weights stay the same objects, no
    window program is made by a flip, and the worker serves after."""
    from dynamo_tpu_torch.profile_decode import serve
    coord = Coordinator("127.0.0.1", 0)
    await coord.start()
    url = f"tcp://127.0.0.1:{coord.port}"
    w = await start_gpu_worker(url, "agg")
    client = w.rt.require_coordinator()
    try:
        engine, params = w.engine, w.engine.runner.params
        ptrs = sorted(t.data_ptr() for t in _tensors(params))
        programs = engine.runner.window_programs()["programs"]

        async def registered():
            insts = [i["k"] for i in await client.kv_get_prefix(
                "instances/")]
            cards = [i["k"] for i in await client.kv_get_prefix("models/")]
            return insts, cards

        insts, cards = await registered()
        assert insts == [f"instances/{NS}/gpu/generate/{w.hex}"]
        assert len(cards) == 1
        for epoch, role in enumerate(("prefill", "decode", "agg"), 1):
            out = await w.mgr.set_role(role, epoch)
            assert out["outcome"] == "ok", out
            insts, cards = await registered()
            comp = "prefill" if role == "prefill" else "gpu"
            assert insts == [f"instances/{NS}/{comp}/generate/{w.hex}"], (
                role, insts)
            assert len(cards) == (0 if role == "prefill" else 1), (
                role, cards)
            assert w.engine is engine and w.engine.runner.params is params
            assert sorted(t.data_ptr() for t in _tensors(params)) == ptrs
            assert engine.runner.window_programs()["programs"] == programs
        assert len(w.handlers) == 1  # the decode profile's, closed since
        req = {"model": "tiny-test", "token_ids": list(range(5, 40)),
               "stop_conditions": {"max_tokens": 8, "ignore_eos": True},
               "sampling_options": {}}
        (res,) = await serve(engine, [req])
        assert len(res["tokens"]) == 8
        status = await client.kv_get(treconfig.role_status_key(
            NS, w.rt.instance_id))
        assert (status["role"], status["epoch"], status["flips"],
                status["backend"] if "backend" in status else "gpu") == (
            "agg", 3, 3, "gpu")
    finally:
        await stop_gpu_worker(w)
        await coord.stop()


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dict__"):
        for v in vars(tree).values():
            yield from _tensors(v)


async def start_jax_mocker_worker(url, role="decode"):
    rt = await JDistributedRuntime.from_settings(JRuntimeConfig(
        coordinator_url=url, lease_ttl_s=2.0, namespace=NS))
    engine = JMockerEngine(JMockerConfig(**FAST))

    async def build(r):
        prof = jreconfig.ServingProfile(r)
        comp = "prefill" if r == "prefill" else "mocker"
        ep = rt.namespace(NS).component(comp).endpoint("generate")
        return prof.add_server(await ep.serve_endpoint(
            engine.handler(), graceful_shutdown=False))

    mgr = jreconfig.RoleManager(rt, build, role=role, drain_s=0.2)
    await mgr.start()
    engine.start()
    return SimpleNamespace(rt=rt, engine=engine, mgr=mgr,
                           hex=f"{rt.instance_id:x}")


@async_test(timeout=180)
async def test_mixed_fleet_flips_both_ways():
    """One coordinator (the JAX package's), a port GPU worker and a JAX
    mocker worker: the JAX planner's RoleReconfigurator flips the port
    worker, the port's flips the JAX worker; each planner reads the
    other package's status bytes."""
    coord = JCoordinator("127.0.0.1", 0)
    await coord.start()
    url = f"tcp://127.0.0.1:{coord.port}"
    port_w = await start_gpu_worker(url, "decode")
    jax_w = await start_jax_mocker_worker(url, "decode")
    j_rt = await JDistributedRuntime.from_settings(JRuntimeConfig(
        coordinator_url=url, namespace=NS))
    t_rt = await DistributedRuntime.from_settings(RuntimeConfig(
        coordinator_url=url, namespace=NS))
    try:
        j_plan = jplanner.RoleReconfigurator(j_rt.require_coordinator(), NS)
        t_plan = tplanner.RoleReconfigurator(t_rt.require_coordinator(), NS)
        fleet_j = {s["worker"]: s["role"] for s in await j_plan.fleet()}
        fleet_t = {s["worker"]: s["role"] for s in await t_plan.fleet()}
        assert fleet_j == fleet_t == {port_w.hex: "decode",
                                      jax_w.hex: "decode"}
        await j_plan.issue(port_w.hex, "prefill", 1)
        await t_plan.issue(jax_w.hex, "agg", 1)
        await wait_for(lambda: (port_w.mgr.role, jax_w.mgr.role) == (
            "prefill", "agg"), timeout=30)

        async def both_views():
            return ({s["worker"]: (s["role"], s["epoch"])
                     for s in await j_plan.fleet()},
                    {s["worker"]: (s["role"], s["epoch"])
                     for s in await t_plan.fleet()})
        deadline = time.monotonic() + 10
        while True:
            jv, tv = await both_views()
            if jv == tv == {port_w.hex: ("prefill", 1),
                            jax_w.hex: ("agg", 1)}:
                break
            assert time.monotonic() < deadline, (jv, tv)
            await asyncio.sleep(0.05)
        # Each planner's next epoch is the same, above both flips.
        jd = await j_plan.pending_directives()
        td = await t_plan.pending_directives()
        assert j_plan._next_epoch(await j_plan.fleet(), jd) == \
            t_plan._next_epoch(await t_plan.fleet(), td) == 2
    finally:
        await t_rt.close()
        await j_rt.close()
        await stop_gpu_worker(port_w)
        await jax_w.engine.stop()
        await jax_w.mgr.stop()
        await jax_w.rt.close()
        await coord.stop()


# ---------------------------------------------------------------------------
# the status server's SetRole verb against the reference's
# ---------------------------------------------------------------------------

async def role_verb_bodies(pk_health, mgr_factory) -> list:
    import json
    import urllib.request
    mgr = await mgr_factory()
    rt = SimpleNamespace(metrics=None)
    server = pk_health.SystemStatusServer(rt, host="127.0.0.1", port=0,
                                          role_manager=mgr)
    await server.start()
    loop = asyncio.get_running_loop()

    def call(method, body=None):
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/control/role", data=data,
            method=method)
        try:
            with urllib.request.urlopen(req) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())
    try:
        out = []
        for method, body in (("GET", None),
                             ("POST", {"role": "prefill", "epoch": 1}),
                             ("POST", {"role": "prefill", "epoch": 1}),
                             ("POST", {"role": "decode", "epoch": 1}),
                             ("POST", {"role": "decode"}),
                             ("POST", b"not json"),
                             ("GET", None)):
            status, payload = await loop.run_in_executor(
                None, call, method, body)
            out.append((status, strip_ts(payload)))
        return out
    finally:
        await server.stop()


@async_test
async def test_status_server_role_verb_matches_reference():
    from dynamo_tpu.runtime import health as jhealth
    from dynamo_tpu_torch.runtime import health as thealth

    async def port_mgr():
        fresh_journals("w")
        mgr, _ = manager(PORT, "agg")
        await mgr.start()
        return mgr

    async def jax_mgr():
        fresh_journals("w")
        mgr, _ = manager(JAX, "agg")
        await mgr.start()
        return mgr

    port = await role_verb_bodies(thealth, port_mgr)
    ref = await role_verb_bodies(jhealth, jax_mgr)
    assert port == ref
    assert [s for s, _ in port] == [200, 200, 200, 409, 400, 400, 200]


# ---------------------------------------------------------------------------
# the worker as a process: a prefill worker publishes
# ---------------------------------------------------------------------------

@async_test(timeout=120)
async def test_prefill_worker_publishes_metrics_and_digests():
    """``--mode prefill`` makes its KV event, load metrics and inventory
    publishers as every role does: its digest reaches the inventory
    subject while it idles, so a flip to agg or decode is seen at once
    by the KV router and the planner."""
    from dynamo_tpu_torch.llm.kv_router.protocols import \
        kv_inventory_subject
    coord = Coordinator("127.0.0.1", 0)
    await coord.start()
    url = f"tcp://127.0.0.1:{coord.port}"
    rt = await DistributedRuntime.from_settings(RuntimeConfig(
        coordinator_url=url))
    sub = await rt.require_coordinator().subscribe(
        kv_inventory_subject(rt.config.namespace, "gpu"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.backends.gpu", "--mode",
         "prefill", "--model", "tiny-test", "--device", "cpu",
         "--num-pages", "64", "--no-kv-plane", "--coordinator-url", url],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: list = []
    # The worker's output is read as it comes: its pipe can outlive it.
    threading.Thread(target=lambda: lines.extend(proc.stdout),
                     daemon=True).start()
    try:
        msg = await asyncio.wait_for(sub.__aiter__().__anext__(), 90)
        assert msg["payload"]["pages_total"] > 0 and "sketch" in \
            msg["payload"]
        assert any("GPU_WORKER_READY mode=prefill" in x for x in lines)
    finally:
        proc.terminate()
        code = await asyncio.get_running_loop().run_in_executor(
            None, proc.wait, 60)
        await sub.cancel()
        await rt.close()
        await coord.stop()
    assert code == 0, lines[-20:]


@async_test
async def test_idle_engine_sleeps_until_work_arrives():
    """An idle GPUEngine's loop waits on its wake event between its
    periodic duties (``IDLE_WAIT_S``) instead of polling every 2 ms, so
    an idle engine beside a busy one (a flipped worker's, a standby's)
    leaves it the interpreter; a request or a job wakes it at once."""
    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.engine import engine as tengine
    from dynamo_tpu_torch.profile_decode import serve
    args = launch.parse_args(["--model", "tiny-test", "--device", "cpu",
                              "--num-pages", "64"])
    engine = launch.build_engine(args)
    try:
        calls = []
        admit = engine._admit

        def counted():
            calls.append(time.monotonic())
            return admit()
        engine._admit = counted
        await asyncio.sleep(0.1)
        n0 = len(calls)
        await asyncio.sleep(0.5)
        idle = len(calls) - n0
        assert idle <= 0.5 / tengine.IDLE_WAIT_S + 10, idle
        t0 = time.monotonic()
        assert await engine.run_job(lambda: 7) == 7
        assert time.monotonic() - t0 < 5 * tengine.IDLE_WAIT_S + 0.5
        req = {"model": "tiny-test", "token_ids": list(range(5, 30)),
               "stop_conditions": {"max_tokens": 4, "ignore_eos": True},
               "sampling_options": {}}
        (res,) = await serve(engine, [req])
        assert len(res["tokens"]) == 4
    finally:
        engine.stop()
