"""The planner in the port (``dynamo_tpu_torch.planner``), its metrics
component and its mocker, against the JAX package's.

- Predictors, ``Planner.step`` (decode and prefill pools, the scaler and
  the reconfigurator beside them) and ``choose_capacity`` give the same
  numbers and decisions for the same scripted ForwardPassMetrics.
- The Kubernetes connector sends the same requests to an API server.
- ``MetricsAggregator`` exposes the same fleet series.
- The mocker publishes the same KV events and load metrics as the JAX
  mocker for the same request script.
- ``profile_sweep`` runs over the mocker and over a ``GPUEngine``
  factory; ``python -m dynamo_tpu_torch.planner`` reads a mocker
  worker's load metrics, prints its steps and exits 0 on SIGTERM.
- The planner reads a decode demand > 0 from a ``GPUEngine`` worker's load
  metrics while streams decode on it, also after a prefill-to-agg flip.
Everything runs on the CPU.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest
from conftest import async_test

from dynamo_tpu import planner as jplanner
from dynamo_tpu.llm.kv_router import protocols as jprotocols
from dynamo_tpu.llm.mocker import MockerConfig as JMockerConfig
from dynamo_tpu.llm.mocker import MockerEngine as JMockerEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime import journal as jjournal
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu.runtime.slo import SloPressure as JSloPressure
from dynamo_tpu_torch import planner as tplanner
from dynamo_tpu_torch.llm.kv_router import protocols as tprotocols
from dynamo_tpu_torch.llm.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime import journal as tjournal
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.slo import SloPressure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(planner=jplanner, protocols=jprotocols,
                      journal=jjournal, pressure=JSloPressure,
                      mocker=(JMockerConfig, JMockerEngine),
                      request=JRequest, context=JContext)
PORT = SimpleNamespace(planner=tplanner, protocols=tprotocols,
                       journal=tjournal, pressure=SloPressure,
                       mocker=(MockerConfig, MockerEngine),
                       request=PreprocessedRequest, context=Context)


def metrics(pk, active=0, waiting=0, total=32, worker=None):
    p = pk.protocols
    return p.ForwardPassMetrics(
        worker_id=worker,
        worker_stats=p.WorkerStats(request_active_slots=active,
                                   request_total_slots=total,
                                   num_requests_waiting=waiting),
        kv_stats=p.KvStats())


# ---------------------------------------------------------------------------
# predictors and decisions
# ---------------------------------------------------------------------------

SERIES = [0, 3, 7, 2, 9, 9, 14, 1, 0, 30, 28, 5]


@pytest.mark.parametrize("name", ["constant", "moving_average", "linear"])
@pytest.mark.parametrize("window", [1, 3, 8])
def test_predictors_match_reference(name, window):
    port = tplanner.make_predictor(name, window=window)
    ref = jplanner.make_predictor(name, window=window)
    assert port.predict() == ref.predict()
    for v in SERIES:
        port.observe(v)
        ref.observe(v)
        assert port.predict() == ref.predict()
    with pytest.raises(ValueError):
        tplanner.make_predictor("prophet")


# Each script: config, connector replicas, [{pool: [(worker, active,
# waiting)]}] one entry a step.
PLANNER_SCRIPTS = {
    "scale_up_on_demand": (
        dict(max_num_seqs_per_worker=8, target_utilization=1.0,
             predictor="constant"), {"gpu": 1},
        [{"decode": [(1, 8, 12)]}]),
    "scale_down_needs_patience": (
        dict(max_num_seqs_per_worker=8, target_utilization=1.0,
             predictor="constant", scale_down_patience=3), {"gpu": 4},
        [{"decode": [(1, 4, 0)]}] * 4),
    "bounds": (
        dict(max_num_seqs_per_worker=1, target_utilization=1.0,
             predictor="constant", max_replicas=4), {"gpu": 1},
        [{"decode": [(1, 50, 50)]}]),
    "prefill_pool": (
        dict(prefill_component="prefill", prefill_capacity_tok_s=1000.0,
             predictor="constant"), {"gpu": 1, "prefill": 1},
        [{"decode": [(1, 1, 0)], "prefill": [(2, 0, 8)]}]),
    "moving_average_ramp": (
        dict(max_num_seqs_per_worker=4, predictor="moving_average",
             predictor_window=3), {},
        [{"decode": [(1, a, w), (2, w, a)]} for a, w in
         [(1, 0), (4, 2), (9, 6), (12, 12), (3, 1), (0, 0)]]),
    "linear_disagg": (
        dict(prefill_component="prefill", predictor="linear",
             prefill_capacity_tok_s=2048.0, scale_down_patience=2),
        {"gpu": 2, "prefill": 1},
        [{"decode": [(1, a, 0)], "prefill": [(5, 0, w), (6, 0, w // 2)]}
         for a, w in [(8, 2), (20, 6), (40, 12), (10, 1), (2, 0),
                      (1, 0)]]),
}


async def run_planner(pk, script) -> tuple:
    cfg_kw, replicas, steps = PLANNER_SCRIPTS[script]
    conn = pk.planner.FakeConnector(dict(replicas))
    planner = pk.planner.Planner(pk.planner.PlannerConfig(
        decode_component="gpu", **cfg_kw), conn)
    outs = []
    for step in steps:
        for pool, rows in step.items():
            for worker, active, waiting in rows:
                getattr(planner, pool).observe(
                    worker, metrics(pk, active, waiting, worker=worker))
        outs.append(await planner.step())
    return outs, conn.calls, conn.replicas, planner.decisions


@pytest.mark.parametrize("script", sorted(PLANNER_SCRIPTS))
@async_test
async def test_planner_steps_match_reference(script):
    port = await run_planner(PORT, script)
    ref = await run_planner(JAX, script)
    assert port == ref
    if script == "scale_up_on_demand":
        assert port[0][0]["decode"]["target"] == 3


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


async def run_planner_with_loops(pk, monkeypatch) -> list:
    """A planner step with the scaler and the reconfigurator beside it:
    the capacity loop owns the worker count, the role loop flips."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    pk.journal._JOURNAL = pk.journal.Journal(capacity=4096, worker="planner")
    fake = FakeCoord()
    for w, role in (("aa", "decode"), ("bb", "decode"), ("cc", "prefill")):
        fake.kv[f"rolestatus/ns/{w}"] = {"worker": w, "role": role,
                                         "state": "serving", "epoch": 0,
                                         "inflight": 1, "ts": 1000.0}
    fake.kv["standby/ns/dd"] = {"worker": "dd", "state": "ready",
                                "ts": 1000.0}
    conn = pk.planner.FakeConnector({"gpu": 2})
    cfg = pk.planner.PlannerConfig(
        namespace="ns", decode_component="gpu", predictor="constant",
        reconfig=pk.planner.ReconfigConfig(enabled=True,
                                           hysteresis_intervals=1),
        capacity=pk.planner.CapacityConfig(enabled=True, component="gpu",
                                           hysteresis_intervals=1,
                                           slots_per_worker=4))
    planner = pk.planner.Planner(cfg, conn)
    pressure = pk.pressure(level=2, worst_burn=9.0, failing=("ttft",))
    clock = [50.0]
    planner.reconfigurator = pk.planner.RoleReconfigurator(
        fake, "ns", cfg.reconfig, pressure_fn=lambda: pressure,
        clock=lambda: clock[0])
    planner.scaler = pk.planner.FleetScaler(
        fake, "ns", cfg.capacity, connector=conn,
        pressure_fn=lambda: pressure, demand_fn=planner._demand,
        clock=lambda: clock[0])
    out = []
    for active in (6, 12):
        planner.decode.observe(1, metrics(pk, active, 2, worker=1))
        out.append(await planner.step())
        clock[0] += 500.0
    out.append(sorted(fake.kv.items()))
    out.append(conn.calls)
    return out


@async_test
async def test_planner_with_scaler_and_reconfigurator_matches_reference(
        monkeypatch):
    port = await run_planner_with_loops(PORT, monkeypatch)
    ref = await run_planner_with_loops(JAX, monkeypatch)
    assert port == ref
    assert port[0]["capacity"]["action"] == "scale_out"


def test_choose_capacity_matches_reference():
    points = [{"isl": 64, "osl": 16, "concurrency": c,
               "ttft_p50_ms": 10.0 * c, "ttft_p99_ms": 20.0 * c,
               "itl_p50_ms": 2.0 + c, "decode_tok_s": 100.0 * c - c * c,
               "prefill_tok_s": 5000.0 / c} for c in (1, 2, 4, 8, 16, 32)]
    table = {"points": points}
    for ttft, itl in ((1e9, 1e9), (100.0, 10.0), (50.0, 100.0)):
        assert tplanner.choose_capacity(table, ttft, itl) == \
            jplanner.choose_capacity(table, ttft, itl)
    for planner in (tplanner, jplanner):
        with pytest.raises(ValueError):
            planner.choose_capacity(table, 0.001, 0.001)


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

@async_test
async def test_profile_sweep_over_the_mocker_and_a_gpu_engine(tmp_path):
    """``profile_sweep`` drives the port's mocker and a ``GPUEngine``
    (tiny-test on the CPU) through the same grid; ``choose_capacity``
    picks a point of each, and the planner takes its numbers."""
    from dynamo_tpu_torch import launch

    def mocker():
        eng = MockerEngine(MockerConfig(speedup_ratio=50.0))
        eng.start()
        return eng

    def gpu_engine():
        args = launch.parse_args(["--model", "tiny-test", "--device", "cpu",
                                  "--num-pages", "64"])
        return launch.build_engine(args)

    grid = [(32, 4, 1), (32, 4, 3)]
    for factory, out in ((mocker, tmp_path / "mocker.json"),
                         (gpu_engine, None)):
        table = await tplanner.profile_sweep(
            factory, grid, output_path=str(out) if out else None)
        assert [(p["isl"], p["osl"], p["concurrency"])
                for p in table["points"]] == grid
        for p in table["points"]:
            assert p["decode_tok_s"] > 0 and p["ttft_p99_ms"] > 0
        cap = tplanner.choose_capacity(table, 1e9, 1e9)
        assert cap["decode_capacity_tok_s"] == max(
            p["decode_tok_s"] for p in table["points"])
    assert json.loads((tmp_path / "mocker.json").read_text())["points"]


# ---------------------------------------------------------------------------
# the Kubernetes connector against a recording API server
# ---------------------------------------------------------------------------

class RecordingKube:
    """apps/v1 StatefulSet GET, GET/PATCH /scale; records each request."""

    def __init__(self):
        self.replicas = {"g-gpu": 2}
        self.requests = []
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, body):
                raw = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _record(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else None
                fake.requests.append((
                    self.command, self.path,
                    self.headers.get("Authorization"),
                    self.headers.get("Content-Type"), body))
                name = self.path.split("/statefulsets/")[-1].split("/")[0]
                return name, body

            def do_GET(self):
                name, _ = self._record()
                if name not in fake.replicas:
                    self._reply(404, {"kind": "Status", "code": 404})
                    return
                self._reply(200, {"spec": {"replicas": fake.replicas[name]}})

            def do_PATCH(self):
                name, body = self._record()
                if name not in fake.replicas:
                    self._reply(404, {"kind": "Status", "code": 404})
                    return
                fake.replicas[name] = body["spec"]["replicas"]
                self._reply(200, {"spec": body["spec"]})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_port}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


async def kube_requests(kube_mod) -> list:
    fake = RecordingKube()
    try:
        api = kube_mod.KubernetesAPI(base_url=fake.url, token="t0k",
                                     namespace="default")
        conn = kube_mod.KubernetesConnector("g", api=api)
        out = [await conn.current("gpu"), await conn.current("absent")]
        await conn.scale("gpu", 5)
        out.append(await conn.current("gpu"))
        out.append(await api.get_statefulset("g-gpu"))
        out.append(await api.get_statefulset("g-absent"))
        with pytest.raises(kube_mod.KubeAPIError):
            await conn.scale("absent", 1)
        return out + fake.requests
    finally:
        fake.stop()


@async_test
async def test_kube_connector_requests_match_reference():
    from dynamo_tpu.planner import kube as jkube
    from dynamo_tpu_torch.planner import kube as tkube
    port = await kube_requests(tkube)
    ref = await kube_requests(jkube)
    assert port == ref
    assert port[:3] == [2, None, 5]


# ---------------------------------------------------------------------------
# the metrics aggregator
# ---------------------------------------------------------------------------

async def aggregator_samples(pk_metrics, pk_registry, pk) -> dict:
    from prometheus_client.parser import text_string_to_metric_families
    reg = pk_registry()
    rt = SimpleNamespace(metrics=reg)
    agg = pk_metrics.MetricsAggregator(rt, "ns", ["gpu", "prefill"],
                                       stale_s=30.0)

    class Sub:
        def __init__(self, payloads):
            self.payloads = payloads

        def __aiter__(self):
            return self._it()

        async def _it(self):
            for p in self.payloads:
                yield {"payload": p}

    rows = {"gpu": [metrics(pk, 3, 1, worker=0xa), metrics(pk, 5, 0,
                                                           worker=0xb),
                    metrics(pk, 1, 4, worker=0xa)],
            "prefill": [metrics(pk, 0, 2, worker=0xc)]}
    for comp, ms in rows.items():
        for m in ms:
            m.kv_stats.gpu_cache_usage_perc = 0.25
            m.kv_stats.gpu_prefix_cache_hit_rate = 0.5
        await agg._intake(comp, Sub([m.to_wire() for m in ms]))
    out = {}
    for fam in text_string_to_metric_families(reg.expose().decode()):
        for s in fam.samples:
            if not s.name.endswith("_created"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


@async_test
async def test_metrics_aggregator_series_match_reference():
    from dynamo_tpu.components import metrics as jagg
    from dynamo_tpu.runtime.metrics import MetricsRegistry as JRegistry
    from dynamo_tpu_torch.components import metrics as tagg
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
    port = await aggregator_samples(tagg, MetricsRegistry, PORT)
    ref = await aggregator_samples(jagg, JRegistry, JAX)
    assert port == ref
    assert port[("dynamo_tpu_fleet_active_slots", (
        ("component", "gpu"), ("dynamo_component", ""),
        ("dynamo_endpoint", ""), ("dynamo_namespace", "ns")))] == 6.0


# ---------------------------------------------------------------------------
# the mocker against the JAX mocker
# ---------------------------------------------------------------------------

class Recorder:
    def __init__(self):
        self.events, self.metrics = [], []

    async def stored(self, hashes, parent_hash=None):
        self.events.append(("stored", list(hashes)))

    async def removed(self, hashes):
        self.events.append(("removed", list(hashes)))

    async def publish(self, m, force=False):
        wire = m.to_wire()
        if not self.metrics or self.metrics[-1] != wire:
            self.metrics.append(wire)


async def mocker_script(pk, host_blocks) -> tuple:
    Config, Engine = pk.mocker
    rec = Recorder()
    eng = Engine(Config(num_kv_blocks=7, block_size=4, max_num_seqs=2,
                        prefill_tokens_per_s=1e7, decode_step_s=0.0005,
                        host_blocks=host_blocks),
                 kv_publisher=rec, metrics_publisher=rec)
    eng.start()
    outs = []
    try:
        for prompt, n in (([1, 2, 3, 4, 5, 6, 7, 8, 9], 6),
                          ([1, 2, 3, 4, 5, 6, 7, 8, 20, 21], 5),
                          (list(range(30, 47)), 7),
                          ([1, 2, 3, 4, 5, 6, 7, 8, 9], 3)):
            req = pk.request(model="m", token_ids=prompt)
            req.stop_conditions.max_tokens = n
            req.stop_conditions.ignore_eos = True
            toks = []
            async for out in eng.generate(req, pk.context()):
                toks += out.get("token_ids", [])
            outs.append(toks)
            await asyncio.sleep(0.02)  # the loop publishes the idle state
        digest = eng.inventory_digest().to_wire()
        status = eng.kv_status()
    finally:
        await eng.stop()
    return outs, rec.events, rec.metrics, digest, status


@pytest.mark.parametrize("host_blocks", [0, 4])
@async_test
async def test_mocker_publishes_what_the_reference_mocker_does(host_blocks):
    port = await mocker_script(PORT, host_blocks)
    ref = await mocker_script(JAX, host_blocks)
    names = ("tokens", "kv events", "load metrics", "digest", "kv status")
    for name, a, b in zip(names, port, ref):
        assert a == b, name
    assert port[1] and any(kind == "removed" for kind, _ in port[1])


# ---------------------------------------------------------------------------
# the planner and the mocker as processes
# ---------------------------------------------------------------------------

def _lines(proc):
    import queue
    q = queue.Queue()
    threading.Thread(target=lambda: [q.put(x) for x in proc.stdout],
                     daemon=True).start()
    return q


def _drain(q, seen) -> None:
    import queue
    while True:
        try:
            seen.append(q.get_nowait())
        except queue.Empty:
            return


def _wait(q, seen, text, timeout=60.0):
    import queue
    deadline = time.monotonic() + timeout
    while not any(text in x for x in seen):
        assert time.monotonic() < deadline, seen[-20:]
        try:
            seen.append(q.get(timeout=0.5))
        except queue.Empty:
            pass
    return [x for x in seen if text in x]


def test_planner_process_reads_a_mocker_worker_and_exits_on_sigterm():
    """The coordinator, ``python -m dynamo_tpu_torch.backends.mocker`` and
    ``python -m dynamo_tpu_torch.planner --adjustment-interval 0.5
    --decode-component mocker``: while a stream decodes on the mocker,
    the planner's steps see one live worker; SIGTERM exits each 0."""
    env = dict(os.environ, DTPU_LOG="info")
    procs, queues, seen = [], [], []

    def spawn(*argv):
        p = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        queues.append(_lines(p))
        seen.append([])
        return len(procs) - 1

    try:
        c = spawn("dynamo_tpu_torch.runtime.coordinator", "--host",
                  "127.0.0.1", "--port", "0")
        port = _wait(queues[c], seen[c], "COORDINATOR_READY")[0].strip() \
            .rsplit("=", 1)[1]
        url = f"tcp://127.0.0.1:{port}"
        m = spawn("dynamo_tpu_torch.backends.mocker", "--coordinator-url",
                  url, "--speedup-ratio", "0.05")
        _wait(queues[m], seen[m], "MOCKER_READY")
        p = spawn("dynamo_tpu_torch.planner", "--coordinator-url", url,
                  "--adjustment-interval", "0.5", "--decode-component",
                  "mocker", "--predictor", "constant")
        _wait(queues[p], seen[p], "PLANNER_READY")
        stream = subprocess.Popen(
            [sys.executable, "-c", _STREAM_CLIENT, url], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        steps = []
        deadline = time.monotonic() + 60
        while not any(s["live_workers"]["decode"] == 1
                      and s["decisions"]["decode"]["demand"] > 0
                      for s in steps):
            assert time.monotonic() < deadline, seen[p][-10:]
            _drain(queues[p], seen[p])
            steps = [json.loads(x.split(" ", 1)[1]) for x in seen[p]
                     if x.startswith("PLANNER_STEP ")]
            time.sleep(0.2)
        stream.wait(timeout=60)
        for i in (p, m, c):
            procs[i].send_signal(signal.SIGTERM)
            assert procs[i].wait(timeout=30) == 0, seen[i][-20:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.parametrize("mode", ["agg", "prefill"],
                         ids=["agg", "prefill-flipped-to-agg"])
@async_test(timeout=180)
async def test_planner_reads_demand_from_a_gpu_engine_worker(mode):
    """A tiny ``GPUEngine`` worker (``python -m
    dynamo_tpu_torch.backends.gpu --device cpu``; launched as a prefill
    worker and flipped to agg over ``/control/role``, as phase 16e's P,
    or agg from the start) under four streams that outlast two planner
    steps: ``Planner._demand()`` and the steps' decode demand read > 0
    while they decode, from the worker's load metrics on the ``gpu``
    component."""
    from dynamo_tpu_torch.runtime import config as tconfig
    from dynamo_tpu_torch.runtime import coordinator as tcoord
    from dynamo_tpu_torch.runtime import distributed as tdist
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    env = dict(os.environ, DTPU_SYSTEM_ENABLED="1", DTPU_SYSTEM_PORT="0",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.backends.gpu", "--model",
         "tiny-test", "--device", "cpu", "--num-pages", "256",
         "--coordinator-url", coord.url, "--mode", mode], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    q, seen = _lines(proc), []
    stops = []
    try:
        status = int((await asyncio.to_thread(
            _wait, q, seen, "GPU_WORKER_STATUS"))[0].rsplit("=", 1)[1])
        await asyncio.to_thread(_wait, q, seen, "GPU_WORKER_READY")
        if mode == "prefill":
            import urllib.request
            flip = urllib.request.Request(
                f"http://127.0.0.1:{status}/control/role", method="POST",
                data=json.dumps({"role": "agg", "epoch": 1,
                                 "drain_s": 1}).encode(),
                headers={"Content-Type": "application/json"})
            answer = await asyncio.to_thread(
                lambda: urllib.request.urlopen(flip, timeout=30).read())
            assert json.loads(answer)["outcome"] == "ok", answer
        rt = await tdist.DistributedRuntime.from_settings(
            tconfig.RuntimeConfig(coordinator_url=coord.url))
        stops.append(rt.close)
        planner = tplanner.Planner(tplanner.PlannerConfig(
            decode_component="gpu", adjustment_interval_s=0.3),
            tplanner.FakeConnector(), runtime=rt)
        await planner.start()
        stops.append(planner.stop)
        client = await rt.namespace().component("gpu").endpoint(
            "generate").client()
        stops.append(client.close)
        await client.wait_for_instances(30)

        async def stream(i):
            wire = {"model": "tiny-test", "token_ids": list(range(1, 40 + i)),
                    "stop_conditions": {"max_tokens": 200,
                                        "ignore_eos": True},
                    "sampling_options": {}}
            n = 0
            async for item in await client.generate(wire):
                n += len(item.get("token_ids", []))
            return n

        steps0 = len(planner.decisions)
        loads = [asyncio.ensure_future(stream(i)) for i in range(4)]
        demand = []
        while not all(t.done() for t in loads):
            demand.append(sum(planner._demand()))
            await asyncio.sleep(0.02)
        assert [t.result() for t in loads] == [200] * 4
        during = [d["demand"] for d in planner.decisions[steps0:]]
        assert max(demand) > 0, demand
        assert len(during) >= 2 and max(during) > 0, during
    finally:
        for stop in reversed(stops):
            await stop()
        proc.terminate()
        await asyncio.to_thread(proc.wait, 30)
        await coord.stop()


_STREAM_CLIENT = """
import asyncio, sys
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

async def main(url):
    rt = await DistributedRuntime.from_settings(
        RuntimeConfig(coordinator_url=url))
    client = await rt.namespace().component("mocker").endpoint(
        "generate").client()
    await client.wait_for_instances(30)
    wire = {"model": "mock-model", "token_ids": list(range(1, 40)),
            "stop_conditions": {"max_tokens": 40, "ignore_eos": True},
            "sampling_options": {}}
    n = 0
    async for item in await client.generate(wire):
        n += len(item.get("token_ids", []))
    assert n == 40, n
    await client.close()
    await rt.close()

asyncio.run(main(sys.argv[1]))
"""


def test_metrics_aggregator_process_serves_the_fleet():
    """``python -m dynamo_tpu_torch.components.metrics --port 0`` beside a
    mocker worker: its /metrics shows the worker's component series; it
    exits 0 on SIGTERM."""
    import urllib.request
    env = dict(os.environ, DTPU_LOG="info")
    procs = []
    try:
        def spawn(*argv):
            p = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            procs.append((p, _lines(p), []))
            return procs[-1]

        c = spawn("dynamo_tpu_torch.runtime.coordinator", "--host",
                  "127.0.0.1", "--port", "0")
        port = _wait(c[1], c[2], "COORDINATOR_READY")[0].strip().rsplit(
            "=", 1)[1]
        url = f"tcp://127.0.0.1:{port}"
        a = spawn("dynamo_tpu_torch.components.metrics", "--port", "0",
                  "--host", "127.0.0.1", "--components", "mocker",
                  "--coordinator-url", url)
        aport = int(_wait(a[1], a[2], "METRICS_AGGREGATOR_READY")[0]
                    .strip().rsplit("=", 1)[1])
        m = spawn("dynamo_tpu_torch.backends.mocker", "--coordinator-url",
                  url, "--speedup-ratio", "0.05")
        _wait(m[1], m[2], "MOCKER_READY")
        stream = subprocess.run([sys.executable, "-c", _STREAM_CLIENT, url],
                                cwd=ROOT, env=env, timeout=60,
                                capture_output=True, text=True)
        assert stream.returncode == 0, stream.stdout + stream.stderr
        deadline = time.monotonic() + 30
        while True:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{aport}/metrics") as resp:
                text = resp.read().decode()
            if 'dynamo_tpu_fleet_live_workers{component="mocker"' in text:
                break
            assert time.monotonic() < deadline, text[-2000:]
            time.sleep(0.2)
        assert "dynamo_tpu_worker_active_slots" in text
        for proc, _, seen_lines in (m, a, c):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0, seen_lines[-20:]
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
