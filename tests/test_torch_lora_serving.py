"""LoRA adapters served end to end by the port, on tiny-test on the CPU.

- A port worker (``backends.gpu.serve_engine`` with ``adapters``) serves
  two adapter names on one base model through the port front over the
  request plane: each name reaches the engine with its adapter set, and
  each answer is what the engine gives that adapter directly.
- A name whose card the worker registered but whose adapter it does not
  hold: 404 ``adapter_not_found`` at the port front and at the JAX front,
  with the same body; the wire prefix and the card extras are the
  reference's bytes.
- Mixed fleets: the JAX front routes an adapter name to a port worker,
  and the port front an adapter name to a JAX worker (``TPUEngine`` with
  the adapter, the reference's ``register_adapter`` card).
- The entry points as processes: ``backends.gpu --lora`` (agg) and a
  ``--mode prefill`` worker with the same flags behind the port frontend
  (the prefill worker advertises no card), and ``launch --lora`` in
  process mode; ``--lora`` with ``out=dyn`` is refused.
"""

import asyncio
import json
import time

import pytest
import torch
from conftest import async_test
from test_torch_engine import ENGINE_KW
from test_torch_http import call
from test_torch_lora import (ADAPTERS, SPEC_J, lora_engine, make_peft_dir,
                             released, tparams_of)
from test_torch_preprocessor import MODEL
from test_torch_worker import (LEASE_TTL_S, Proc, _models, start_jax_front,
                               start_port_front, wait_for)

import jax
from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import coordinator as jcoord
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu.runtime import errors as jerrors
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import distributed as tdist
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import (AdapterNotFoundError,
                                             error_from_wire)
from dynamo_tpu_torch.runtime.msgpack_lite import packb

torch.set_num_threads(1)

MAX_TOKENS = 6
NAMES = ("tenant-a", "tenant-b")


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(SPEC_J, jax.random.key(21))


def completion_of(model: str) -> dict:
    return {"model": model, "prompt": "the quick brown fox",
            "max_tokens": MAX_TOKENS, "ignore_eos": True}


def tap(engine, seen: list) -> None:
    """Record (adapter, prompt ids, emitted ids) of every request."""
    inner = engine.generate

    async def generate(request, context):
        tokens = []
        view = (request if isinstance(request, dict)
                else request.model_dump())  # the reference's request type
        seen.append((view.get("adapter"), list(view["token_ids"]), tokens))
        async for item in inner(request, context):
            tokens.extend(item.get("token_ids", []))
            yield item

    engine.generate = generate


async def direct(engine, adapter, prompt) -> list:
    """The engine's greedy tokens for ``prompt`` through ``adapter``,
    after its prefix cache is cleared (so the same programs run)."""
    await engine.clear_kv_blocks()
    req = {"model": MODEL, "token_ids": prompt, "adapter": adapter,
           "stop_conditions": {"max_tokens": MAX_TOKENS,
                               "ignore_eos": True}}
    if isinstance(engine, TPUEngine):
        from dynamo_tpu.llm.protocols import PreprocessedRequest
        from dynamo_tpu.runtime.context import Context as JContext
        req, ctx = PreprocessedRequest.from_wire(req), JContext()
    else:
        ctx = Context()
    out = []
    async for item in engine.generate(req, ctx):
        out.extend(item.get("token_ids", []))
    return out


async def port_lora_worker(url, jparams, names=NAMES):
    """A port worker with ``lora_engine``'s two adapters, serving the base
    model and an adapter card per name in ``names``."""
    engine = lora_engine(tparams_of(jparams))
    engine.start()
    rt = await tdist.DistributedRuntime.from_settings(
        tconfig.RuntimeConfig(coordinator_url=url, lease_ttl_s=LEASE_TTL_S))
    server = await gpu.serve_engine(rt, engine, MODEL, make_test_tokenizer(),
                                    adapters=list(names))

    async def stop():
        await server.shutdown()
        engine.stop()
        await rt.close()
    return engine, stop


async def check_routed(port, engine, seen, names=(MODEL, *NAMES)):
    """Each name through the front at ``port``: 200, its adapter on the
    request, the engine's direct answer for that adapter; the adapters'
    answers differ from the base model's."""
    by_name = {}
    for name in names:
        status, _, raw = await call(port, "POST", "/v1/completions",
                                    completion_of(name))
        assert status == 200, raw[:300]
        adapter, prompt, tokens = seen[-1]
        assert adapter == (None if name == MODEL else name)
        assert len(tokens) == MAX_TOKENS
        assert tokens == await direct(engine, adapter, prompt)
        by_name[name] = tokens
    assert len({tuple(t) for t in by_name.values()}) == len(names)


async def wait_models(manager, names):
    await wait_for(lambda: all(manager.get(n) is not None for n in names))


@async_test(timeout=180)
async def test_two_adapter_names_on_one_base_through_the_port_front(jparams):
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    engine, stop_worker = await port_lora_worker(coord.url, jparams)
    seen = []
    tap(engine, seen)
    f_rt, service, watcher = await start_port_front(coord.url)
    try:
        await wait_models(watcher.manager, (MODEL, *NAMES))
        status, _, raw = await call(service.port, "GET", "/v1/models")
        assert status == 200 and all(n.encode() in raw for n in NAMES)
        card = watcher.manager.get("tenant-a").entry.card
        assert card.runtime_config.extra["lora_base"] == MODEL
        await check_routed(service.port, engine, seen)
        # Both adapters stay resident once no request holds one.
        status = await released(engine)
        assert set(status["resident"]) == set(NAMES)
    finally:
        await service.stop()
        await watcher.stop()
        await stop_worker()
        await f_rt.close()
        await coord.stop()


@async_test(timeout=180)
async def test_unknown_adapter_is_a_404_on_both_fronts(jparams):
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    _, stop_worker = await port_lora_worker(coord.url, jparams,
                                            names=("ghost",))
    fronts = [await start_port_front(coord.url),
              await start_jax_front(coord.url)]
    try:
        bodies = []
        for _, service, watcher in fronts:
            await wait_models(watcher.manager, ("ghost",))
            for stream in (False, True):
                status, _, raw = await call(
                    service.port, "POST", "/v1/completions",
                    dict(completion_of("ghost"), stream=stream))
                assert status == 404, raw[:300]
                bodies.append(raw)
        body = json.loads(bodies[0])
        assert body["error"]["type"] == "adapter_not_found"
        assert "'ghost' is not registered" in body["error"]["message"]
        assert len(set(bodies)) == 1, bodies
    finally:
        for rt, service, watcher in fronts:
            await service.stop()
            await watcher.stop()
            await rt.close()
        await stop_worker()
        await coord.stop()


def test_wire_prefix_and_card_extras_are_the_references():
    assert AdapterNotFoundError.WIRE_PREFIX == \
        jerrors.AdapterNotFoundError.WIRE_PREFIX
    exc = error_from_wire(f"{jerrors.AdapterNotFoundError.WIRE_PREFIX}gone")
    assert type(exc) is AdapterNotFoundError and str(exc) == "gone"

    async def card_of(mod, runtime_cls, config_cls, tok):
        coord = tcoord.Coordinator("127.0.0.1", 0)
        await coord.start()
        rt = await runtime_cls.from_settings(config_cls(
            coordinator_url=coord.url))
        try:
            ep = rt.namespace("dynamo").component("gpu").endpoint(
                "generate")
            entry = await mod.register_adapter(rt, ep, "tenant-a", MODEL,
                                               tok, context_length=256)
            got = await rt.require_coordinator().kv_get_prefix("models/")
            return entry.to_wire(), [e["v"] for e in got]
        finally:
            await rt.close()
            await coord.stop()

    ours, ours_kv = asyncio.run(card_of(
        tcard, tdist.DistributedRuntime, tconfig.RuntimeConfig,
        make_test_tokenizer()))
    ref, ref_kv = asyncio.run(card_of(jcard, jdist.DistributedRuntime,
                                      jconfig.RuntimeConfig,
                                      j_test_tokenizer()))
    extra = {"lora_base": MODEL, "adapter": "tenant-a"}
    assert ours["card"]["runtime_config"]["extra"] == extra
    assert packb(ours["card"]["runtime_config"]) == \
        packb(ref["card"]["runtime_config"])
    # Each front reads the other package's entry back to the binding.
    assert tcard.ModelEntry.from_wire(ref_kv[0]).card.runtime_config \
        .extra == extra
    assert jcard.ModelEntry.from_wire(ours_kv[0]).card.runtime_config \
        .extra == extra


@async_test(timeout=180)
async def test_jax_front_routes_an_adapter_name_to_a_port_worker(jparams):
    coord = jcoord.Coordinator()
    await coord.start()
    engine, stop_worker = await port_lora_worker(coord.url, jparams)
    seen = []
    tap(engine, seen)
    f_rt, service, watcher = await start_jax_front(coord.url)
    try:
        await wait_models(watcher.manager, (MODEL, *NAMES))
        await check_routed(service.port, engine, seen)
    finally:
        await service.stop()
        await watcher.stop()
        await stop_worker()
        await f_rt.close()
        await coord.stop()


@async_test(timeout=180)
async def test_port_front_routes_an_adapter_name_to_a_jax_worker(jparams):
    jeng = TPUEngine(jcfg.EngineConfig(
        model=SPEC_J, attention_backend="xla", max_adapters=2,
        lora_max_rank=8, **ENGINE_KW), params=jparams)
    for name, slot in zip(NAMES, (1, 2)):
        jeng.register_adapter(name, weights=ADAPTERS[slot])
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
    for name in NAMES:
        await jcard.register_adapter(w_rt, ep, name, MODEL,
                                     j_test_tokenizer(), context_length=256)
    f_rt, service, watcher = await start_port_front(coord.url)
    try:
        await wait_models(watcher.manager, (MODEL, *NAMES))
        await check_routed(service.port, jeng, seen)
    finally:
        await service.stop()
        await watcher.stop()
        await server.shutdown()
        jeng.stop()
        await f_rt.close()
        await w_rt.close()
        await coord.stop()


@pytest.mark.parametrize("argv,want", [
    ([], (0, 8)),
    (["--lora", "a=/x", "--lora", "b=/y"], (4, 8)),
    ([f"--lora=n{i}=/x" for i in range(6)], (6, 8)),
    (["--lora", "a=/x", "--max-adapters", "2", "--max-lora-rank", "16"],
     (2, 16)),
], ids=["none", "two", "six", "explicit"])
def test_lora_flags_size_the_slots(argv, want):
    """--max-adapters defaults to max(4, number of --lora), as in the
    reference; the launcher and the worker read the flags alike."""
    base = ["--model", MODEL, "--device", "cpu", "--num-pages", "8"]
    wcfg = gpu.build_engine_config(gpu.parse_args(base + argv))
    lcfg = launch.build_engine_config(launch.parse_args(base + argv))
    assert (wcfg.max_adapters, wcfg.lora_max_rank) == want
    assert (lcfg.max_adapters, lcfg.lora_max_rank) == want


def test_lora_flags_refused_where_the_reference_refuses(capsys):
    with pytest.raises(SystemExit) as exc:
        launch.parse_args(["out=dyn", "--lora", "a=/x"])
    assert exc.value.code == 2
    assert "--lora needs the real engine (out=gpu)" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="NAME=PATH"):
        launch.lora_args(launch.parse_args(["--lora", "no-path"]))


def test_lora_entry_points_as_processes(tmp_path):
    dirs = [make_peft_dir(tmp_path / name, rank=4, alpha=8.0,
                          targets=("q_proj", "v_proj", "o_proj", "up_proj"),
                          seed=i) for i, name in enumerate(NAMES)]
    loras = [a for name, d in zip(NAMES, dirs)
             for a in ("--lora", f"{name}={d}")]
    engine_args = ("--model", MODEL, "--device", "cpu", "--num-pages", "64")
    procs = []
    try:
        coord = Proc("dynamo_tpu_torch.runtime.coordinator", "--host",
                     "127.0.0.1", "--port", "0")
        procs.append(coord)
        launcher = Proc("dynamo_tpu_torch.launch", *engine_args,
                        "--http-port", "0", *loras[:2])
        procs.append(launcher)
        url = f"tcp://127.0.0.1:{coord.port('COORDINATOR_READY')}"
        worker = Proc("dynamo_tpu_torch.backends.gpu", *engine_args,
                      "--coordinator-url", url, *loras)
        prefill = Proc("dynamo_tpu_torch.backends.gpu", *engine_args,
                       "--mode", "prefill", "--coordinator-url", url,
                       *loras)
        front = Proc("dynamo_tpu_torch.frontend", "--http-host",
                     "127.0.0.1", "--http-port", "0", "--coordinator-url",
                     url)
        procs += [worker, prefill, front]
        worker.wait_line("GPU_WORKER_READY mode=agg")
        ready = prefill.wait_line("GPU_WORKER_READY mode=prefill")
        prefill_id = ready.split("worker=")[1].split()[0]

        async def keys():
            rt = await tdist.DistributedRuntime.from_settings(
                tconfig.RuntimeConfig(coordinator_url=url))
            try:
                got = await rt.require_coordinator().kv_get_prefix("models/")
                return [e["k"] for e in got]
            finally:
                await rt.close()
        models = asyncio.run(keys())
        assert sorted(k.split("/")[1] for k in models) == sorted(
            (MODEL, *NAMES))
        assert not any(k.endswith(f"/{prefill_id}") for k in models)
        lport = launcher.port("LAUNCH_READY in=http out=gpu")
        fport = front.port("FRONTEND_READY")
        for port, names in ((fport, (MODEL, *NAMES)),
                            (lport, (MODEL, NAMES[0]))):
            deadline = time.monotonic() + 60
            while not all(n.encode() in _models(port) for n in names):
                assert time.monotonic() < deadline
                time.sleep(0.05)
            for name in names:
                status, _, raw = asyncio.run(call(
                    port, "POST", "/v1/completions", completion_of(name)))
                assert status == 200, raw[:300]
            status, _, raw = asyncio.run(call(
                port, "POST", "/v1/completions", completion_of("nobody")))
            assert status == 404
        for proc in (launcher, worker, prefill, front, coord):
            assert proc.stop() == 0, proc.seen[-20:]
    finally:
        for proc in procs:
            proc.kill()
