"""Disaggregated prefill and decode in the port against the JAX package
(``tests/test_disagg.py`` mirrored, on the CPU at tiny-test widths).

- Extract and insert: within the port, prefill -> extract -> chunks ->
  insert into other pages of a fresh runner -> extract is bit-exact on
  both pools. A parcel of either package (bf16 or packed int8) inserted
  into a port pool gives the pool bytes the JAX runner's insert gives,
  for every pair of parcel form and pool type: a bf16 parcel goes into an
  int8 pool through ``quantize_np``, a packed one into a bf16 pool
  through ``dequantize_np``.
- Same-package 1P1D (port prefill worker -> port decode worker over the
  request plane), on the KV plane and inline, bf16 and int8 pools:
  greedy tokens (whole prompts and a chunked, chunk-streamed one), a
  penalised request and a seeded sampled request equal the port's
  aggregated engine with the same weights, exactly.
- Mixed fleets: a JAX prefill worker (``TPUEngine``, its
  ``KvPlaneServer`` and handler) -> a port decode worker, and a port
  prefill worker -> a JAX decode worker, bf16 and int8: greedy tokens
  equal the JAX aggregated engine's wherever the reference's top-2
  margin exceeds a bf16 ulp (ROADMAP "Greedy tokens only at clear
  margins"; for int8 the margin is read from the reference's int8-pool
  logits, as in ``test_torch_engine.py``).
- Handler behaviour: a short prompt stays local; a ``disagg/<model>``
  update takes effect; no prefill worker, and a dead plane, fall back to
  local prefill (``remote_failures`` counts them); ``clear_kv_blocks``
  clears the decode pool and fans out to the prefill workers; an
  injection with no free pages prefills locally and a malformed parcel
  ends the stream with its error; a streamed extract whose chunk fails
  fails every pending page group; adapter requests are refused on
  extract.
- The worker CLI accepts the seven disagg flags, and a coordinator, a
  ``--mode prefill`` and a ``--mode decode`` worker and the frontend, as
  processes on the CPU, answer a streamed chat whose prompt is over the
  threshold through the prefill worker, and exit 0 on SIGTERM.
"""

import asyncio
import json
import signal
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from conftest import async_test
from test_torch_engine import (ENGINE_KW, SPEC_J, SPEC_T, _bf16_ulp,
                               _ref_int8_logits, _ref_logits)
from test_torch_http import _call, sse_events
from test_torch_worker import Proc, _models, _stream_chat

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import runner as jrunner
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import disagg as jdisagg
from dynamo_tpu.llm import kv_plane as jplane
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.llm import disagg as tdisagg
from dynamo_tpu_torch.llm import kv_transfer as txfer
from dynamo_tpu_torch.llm.kv_plane import KvPlaneClient, KvPlaneServer
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import distributed as tdist
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import InvalidRequestError

torch.set_num_threads(1)

PAGE = ENGINE_KW["page_size"]
MAX_LOCAL = 8  # prompts longer than this prefill remotely


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(
        0, SPEC_T.vocab_size, size=n).tolist()


def _wire(prompt, max_tokens, **sampling) -> dict:
    return {"model": "tiny-test", "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens},
            "sampling_options": sampling}


async def _tokens(agen) -> list[int]:
    toks = []
    async for out in agen:
        toks.extend(out.get("token_ids", []))
    return toks


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(SPEC_J, jax.random.key(45))


def _tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), SPEC_T,
                           device="cpu")


def port_engine(params=None, quant_kv=None) -> GPUEngine:
    return GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       quant_kv=quant_kv, **ENGINE_KW),
                     params=params, seed=0)


def jax_engine(jparams, quant_kv=None) -> TPUEngine:
    return TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       quant_kv=quant_kv, **ENGINE_KW),
                     params=jparams)


# ---------------------------------------------------------------------------
# Extract and insert
# ---------------------------------------------------------------------------

def _pool_pages(runner, pages) -> list[np.ndarray]:
    """Both pools' bytes at ``pages`` (int8 data and scale bytes for an
    int8 pool), from either package's runner."""
    out = []
    for cache in (runner.k_cache, runner.v_cache):
        for t in (cache if isinstance(cache, tuple) else (cache,)):
            if torch.is_tensor(t):
                t = (t.view(torch.int16) if t.dtype == torch.bfloat16
                     else t).numpy()
            out.append(np.asarray(t)[:, :, pages].view(np.uint8))
    return out


def _prefilled(runner_cls, seq_cls, cfg, params, prompt, pages):
    runner = runner_cls(cfg, params=params)
    seq = seq_cls(tokens=np.asarray(prompt, np.int32), start_pos=0,
                  chunk_pages=np.asarray(pages, np.int32), hist_pages=None,
                  sampling=(0.0, 0, 1.0))
    runner.prefill_batch([seq])
    return runner


@pytest.fixture(scope="module")
def runners(jparams):
    """Prefilled runners of both packages and both pools:
    {(package, pool): runner}, each holding one prompt in pages 1-3."""
    prompt = _prompt(1, 40)
    tparams = _tparams(jparams)
    out = {}
    for pool in ("bf16", "int8"):
        quant = None if pool == "bf16" else "int8"
        out["jax", pool] = _prefilled(
            jrunner.ModelRunner, jrunner.PrefillSeq,
            jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                              quant_kv=quant, **ENGINE_KW),
            jparams, prompt, [1, 2, 3])
        out["port", pool] = _prefilled(
            trunner.ModelRunner, trunner.PrefillSeq,
            tcfg.EngineConfig(model=SPEC_T, device="cpu", quant_kv=quant,
                              **ENGINE_KW), tparams, prompt, [1, 2, 3])
    return out


def _port_parcel(parcel: np.ndarray) -> np.ndarray:
    return parcel.view(np.uint16) if parcel.dtype == ml_dtypes.bfloat16 \
        else parcel


def _jax_parcel(parcel: np.ndarray) -> np.ndarray:
    return parcel.view(ml_dtypes.bfloat16) if parcel.dtype == np.uint16 \
        else parcel


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_extract_insert_roundtrip_bit_exact(runners, pool):
    src = runners["port", pool]
    kv = src.extract_pages([1, 2, 3])
    assert kv.dtype == (np.uint16 if pool == "bf16" else np.uint8)
    d = SPEC_T.head_dim + (4 if pool == "int8" else 0)
    assert kv.shape == (2, SPEC_T.num_layers, SPEC_T.num_kv_heads, 3, PAGE, d)
    meta, chunks = txfer.kv_to_chunks(kv)
    kv2 = txfer.kv_from_chunks(meta, chunks)
    np.testing.assert_array_equal(kv2, kv)
    fresh = trunner.ModelRunner(tcfg.EngineConfig(
        model=SPEC_T, device="cpu",
        quant_kv=None if pool == "bf16" else "int8", **ENGINE_KW))
    fresh.insert_pages(kv2, [7, 5, 11])
    np.testing.assert_array_equal(fresh.extract_pages([7, 5, 11]), kv)
    for a, b in zip(_pool_pages(fresh, [7, 5, 11]),
                    _pool_pages(src, [1, 2, 3])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("parcel_pool,target_pool", [
    ("bf16", "bf16"), ("int8", "int8"), ("bf16", "int8"), ("int8", "bf16")],
    ids=["bf16-into-bf16", "packed-into-int8", "bf16-into-int8",
         "packed-into-bf16"])
def test_insert_pool_bytes_equal_reference(runners, source, parcel_pool,
                                           target_pool):
    parcel = _port_parcel(runners[source, parcel_pool].extract_pages(
        [1, 2, 3]))
    pages = [9, 4, 12]
    jtarget, ttarget = runners["jax", target_pool], runners["port",
                                                            target_pool]
    jtarget.insert_pages(_jax_parcel(parcel), pages)
    ttarget.insert_pages(parcel, pages)
    want = _pool_pages(jtarget, pages)
    got = _pool_pages(ttarget, pages)
    assert len(got) == len(want) == (2 if target_pool == "bf16" else 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # The port's extract of those pages is the JAX runner's parcel.
    np.testing.assert_array_equal(
        ttarget.extract_pages(pages),
        _port_parcel(jtarget.extract_pages(pages)))


# ---------------------------------------------------------------------------
# 1P1D stacks
# ---------------------------------------------------------------------------

class _Stack:
    pass


async def start_stack(p_engine, d_engine, plane=True, max_local=MAX_LOCAL,
                      watch=False):
    """A prefill worker serving ``p_engine`` (a GPUEngine or a TPUEngine:
    its package's handler, runtime and plane) and a decode handler over
    ``d_engine`` (likewise), on a port coordinator over TCP."""
    s = _Stack()
    s.coord = tcoord.Coordinator("127.0.0.1", 0)
    await s.coord.start()
    p_jax = isinstance(p_engine, TPUEngine)
    d_jax = isinstance(d_engine, TPUEngine)

    def runtime(is_jax):
        pkg, conf = (jdist, jconfig) if is_jax else (tdist, tconfig)
        return pkg.DistributedRuntime.from_settings(conf.RuntimeConfig(
            coordinator_url=s.coord.url, lease_ttl_s=3.0))

    s.p_rt, s.d_rt = await runtime(p_jax), await runtime(d_jax)
    s.p_engine, s.d_engine = p_engine, d_engine
    s.plane = None
    if plane:
        s.plane = (jplane.KvPlaneServer(use_jax_path=False) if p_jax
                   else KvPlaneServer())
        s.plane.start()
    make = (jdisagg if p_jax else tdisagg).make_prefill_handler
    ep = s.p_rt.namespace("test").component("prefill").endpoint("generate")
    s.p_server = await ep.serve_endpoint(make(p_engine, plane=s.plane),
                                         graceful_shutdown=True)
    dis = jdisagg if d_jax else tdisagg
    pc_ep = s.d_rt.namespace("test").component("prefill").endpoint("generate")
    s.prefill_client = await pc_ep.client()
    await s.prefill_client.wait_for_instances(timeout=10)
    if watch:
        s.config = await dis.DisaggRouterConfig.from_coordinator_with_watch(
            s.d_rt.require_coordinator(), "tiny-test",
            default_max_local=max_local)
    else:
        s.config = dis.DisaggRouterConfig(max_local_prefill_length=max_local)
    s.handler = dis.DisaggDecodeHandler(d_engine, s.prefill_client, s.config)
    if d_jax:
        s.handler.plane_client._use_jax = False  # the socket path
    s.handle = s.handler.handler()
    return s


async def stop_stack(s) -> None:
    await s.prefill_client.close()
    await s.config.close()
    await s.p_server.shutdown()
    s.handler.plane_client.close()
    if s.plane is not None:
        s.plane.close()
    await s.d_rt.close()
    await s.p_rt.close()
    await s.coord.stop()


async def _serve(s, request) -> list[int]:
    """One request through the decode handler."""
    if isinstance(s.d_engine, TPUEngine):
        return await _tokens(s.handle(JRequest.from_wire(request),
                                      JContext()))
    return await _tokens(s.handle(dict(request), Context()))


async def _agg(engine, request) -> list[int]:
    if isinstance(engine, TPUEngine):
        return await _tokens(engine.generate(JRequest.from_wire(request),
                                             JContext()))
    return await _tokens(engine.generate(dict(request), Context()))


@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("plane", [True, False], ids=["plane", "inline"])
@async_test(timeout=120)
async def test_port_1p1d_equals_aggregated(jparams, plane, quant_kv):
    tparams = _tparams(jparams)
    engines = [port_engine(tparams, quant_kv) for _ in range(3)]
    p_engine, d_engine, agg = engines
    s = await start_stack(p_engine, d_engine, plane=plane)
    try:
        seed = 3 if plane else 4
        requests = [_wire(_prompt(seed, 24), 10), _wire(_prompt(seed, 47), 9),
                    # Over max_prefill_tokens (64): a chunked prefill,
                    # chunk-streamed over the plane in two page groups.
                    _wire(_prompt(seed, 100), 8),
                    _wire(_prompt(seed + 10, 30), 8, frequency_penalty=0.5,
                          presence_penalty=1.0),
                    _wire(_prompt(seed + 20, 33), 10, temperature=0.9,
                          top_p=0.95, seed=1234)]
        got = [await _serve(s, r) for r in requests]
        want = [await _agg(agg, r) for r in requests]
        assert got == want
        assert [len(t) for t in got] == [10, 9, 8, 8, 10]
        assert (s.handler.remote_prefills, s.handler.remote_failures,
                s.handler.local_prefills) == (5, 0, 0)
        assert d_engine.injected_admissions == 5
        if plane:
            assert s.plane.transfers == 5
            assert p_engine.streamed_extracts == 5
            assert s.handler.plane_client.transfers == 5
        else:
            assert s.handler.plane_client.transfers == 0
    finally:
        await stop_stack(s)
        for e in engines:
            e.stop()


def _assert_clear_margins(jparams, prompt, ref, got, quant_kv) -> int:
    """``got`` equals the reference chain ``ref`` up to a split at a
    near-tie of the reference's logits; returns the tokens compared
    equal."""
    for i, (a, b) in enumerate(zip(ref, got)):
        if a == b:
            continue
        logits = (_ref_logits(jparams, prompt + ref[:i]) if quant_kv is None
                  else _ref_int8_logits(jparams, prompt, ref[:i + 1])[i])
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin <= _bf16_ulp(top2[1]), (
            f"token {i}: {b} != reference {a} at a clear margin {margin:.4f}")
        return i
    assert len(got) == len(ref)
    return len(ref)


@pytest.fixture(scope="module")
def jax_engines(jparams):
    """One TPUEngine per pool type, shared by the mixed-fleet cases (each
    compiles its programs once)."""
    engines = {}
    yield lambda quant_kv: engines.setdefault(
        quant_kv, jax_engine(jparams, quant_kv))
    for e in engines.values():
        e.stop()


@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@async_test(timeout=180)
async def test_mixed_fleet_greedy_at_clear_margins(jparams, jax_engines,
                                                   direction, quant_kv):
    """The JAX engine is the aggregated reference (served first, so no
    reference prompt is in any cache) and the JAX side of the fleet."""
    jeng = jax_engines(quant_kv)
    teng = port_engine(_tparams(jparams), quant_kv)
    p_engine, d_engine = ((jeng, teng) if direction == "jax-to-port"
                          else (teng, jeng))
    prompts = [_prompt(5 if direction == "jax-to-port" else 6, n)
               for n in (24, 40, 57)]
    max_tokens = 8
    s = None
    try:
        ref = [await _agg(jeng, _wire(p, max_tokens)) for p in prompts]
        s = await start_stack(p_engine, d_engine, plane=True)
        got = [await _serve(s, _wire(p, max_tokens)) for p in prompts]
        assert (s.handler.remote_prefills, s.handler.remote_failures) == (3, 0)
        assert s.plane.transfers == 3
        compared = sum(_assert_clear_margins(jparams, p, r, g, quant_kv)
                       for p, r, g in zip(prompts, ref, got))
        assert compared >= 12
    finally:
        if s is not None:
            await stop_stack(s)
        teng.stop()


# ---------------------------------------------------------------------------
# Handler behaviour
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """A port prefill engine and decode engine (random weights, seed 0),
    shared by the handler tests; each test uses its own prompts."""
    engines = (port_engine(), port_engine())
    yield engines
    for e in engines:
        e.stop()


@async_test(timeout=60)
async def test_short_prompt_stays_local(pair):
    s = await start_stack(*pair, max_local=64)
    try:
        await _serve(s, _wire(_prompt(12, 20), 4))
        assert (s.handler.local_prefills, s.handler.remote_prefills) == (1, 0)
        await _serve(s, _wire(_prompt(13, 80), 4))
        assert (s.handler.local_prefills, s.handler.remote_prefills) == (1, 1)
    finally:
        await stop_stack(s)


@async_test(timeout=60)
async def test_disagg_config_dynamic_update(pair):
    s = await start_stack(*pair, watch=True)
    try:
        await s.d_rt.require_coordinator().kv_put(
            tdisagg.disagg_config_key("tiny-test"),
            {"max_local_prefill_length": 1000})
        for _ in range(200):
            if s.config.max_local_prefill_length == 1000:
                break
            await asyncio.sleep(0.02)
        assert s.config.max_local_prefill_length == 1000
        await _serve(s, _wire(_prompt(14, 24), 4))  # now <= 1000: local
        assert (s.handler.remote_prefills, s.handler.local_prefills) == (0, 1)
    finally:
        await stop_stack(s)


@async_test(timeout=60)
async def test_remote_failure_falls_back_to_local(pair):
    """No prefill worker serves: the long prompt prefills locally."""
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    rt = await tdist.DistributedRuntime.from_settings(tconfig.RuntimeConfig(
        coordinator_url=coord.url, lease_ttl_s=3.0))
    try:
        client = await rt.namespace("test").component("prefill") \
            .endpoint("generate").client()
        handler = tdisagg.DisaggDecodeHandler(
            pair[1], client, tdisagg.DisaggRouterConfig(MAX_LOCAL))
        request = _wire(_prompt(15, 24), 6)
        got = await _tokens(handler.generate(dict(request), Context()))
        assert len(got) == 6
        assert (handler.remote_failures, handler.local_prefills) == (1, 1)
        await client.close()
        handler.plane_client.close()
    finally:
        await rt.close()
        await coord.stop()


@async_test(timeout=60)
async def test_plane_death_falls_back_to_local(pair):
    s = await start_stack(*pair)
    try:
        s.plane.close()  # tickets are still issued; pulls now fail
        got = await _serve(s, _wire(_prompt(32, 24), 6))
        assert len(got) == 6
        assert (s.handler.remote_failures, s.handler.local_prefills) == (1, 1)
    finally:
        await stop_stack(s)


@async_test(timeout=60)
async def test_clear_kv_blocks_fans_out_to_prefill_workers(pair):
    s = await start_stack(*pair)
    try:
        await _serve(s, _wire(_prompt(20, 40), 4))  # remote: both register
        p_alloc, d_alloc = pair[0].allocator, pair[1].allocator
        for _ in range(250):  # the decode pages release after the windows
            if not (p_alloc.num_active or d_alloc.num_active):
                break
            await asyncio.sleep(0.02)
        assert not (p_alloc.num_active or d_alloc.num_active)
        held = len(p_alloc.inactive) + len(d_alloc.inactive)
        assert p_alloc.inactive and d_alloc.inactive
        out = [item async for item in s.handle({"clear_kv_blocks": True},
                                               Context())]
        assert out == [{"cleared": held}]
        assert not p_alloc.inactive and not d_alloc.inactive
        # A plain engine's handler serves it too; embed is answered on
        # both, the decode worker's from its own engine, as the
        # reference's.
        items = [i async for i in pair[0].handler()({"clear_kv_blocks": True},
                                                    Context())]
        assert items == [{"cleared": 0}]
        embed = {"embed": True, "token_lists": [[3, 4, 5]]}
        for handle, engine in ((pair[0].handler(), pair[0]),
                               (s.handle, pair[1])):
            items = [i async for i in handle(dict(embed), Context())]
            assert items == [{"embeddings": await engine.embed(
                embed["token_lists"], "last")}]
    finally:
        await stop_stack(s)


@async_test(timeout=60)
async def test_injection_without_pages_or_with_a_bad_parcel(pair):
    """No free pages for the parcel: the request prefills locally and
    gives the aggregated tokens. A parcel that does not fit the prompt
    ends the stream with the injection error."""
    p_engine, d_engine = pair
    request = _wire(_prompt(21, 40), 6)
    first, kv, _ = await p_engine.run_job(
        lambda: p_engine.prefill_extract(
            PreprocessedRequest.from_wire(request)))
    want = await _agg(d_engine, request)
    await d_engine.clear_kv_blocks()
    alloc = d_engine.allocator
    inner = alloc.allocate
    refused = []

    def allocate(count):
        if count == kv.shape[3] and not refused:
            refused.append(count)
            return None
        return inner(count)

    alloc.allocate = allocate
    try:
        got = await _tokens(d_engine.generate_injected(
            dict(request), Context(), first, kv))
    finally:
        del alloc.allocate
    assert refused and got == want
    with pytest.raises(RuntimeError, match="kv injection failed"):
        await _tokens(d_engine.generate_injected(
            dict(request), Context(), first, kv[:, :, :, :1]))


@async_test(timeout=60)
async def test_streamed_extract_failure_fails_every_group(pair):
    """The second chunk of a chunk-streamed extract fails: the job
    raises, and every page group still pending fails its pull."""
    p_engine = pair[0]
    plane = KvPlaneServer()
    plane.start()
    client = KvPlaneClient()
    runner = p_engine.runner
    inner = runner.prefill_chunk_async
    tickets = []

    def second_fails(seq):
        if seq.start_pos:
            raise RuntimeError("injected chunk failure")
        return inner(seq)

    runner.prefill_chunk_async = second_fails
    try:
        req = PreprocessedRequest.from_wire(
            _wire(_prompt(22, 150), 4))  # chunks of 64, 64 and 22 tokens
        with pytest.raises(RuntimeError, match="injected chunk failure"):
            await p_engine.run_job(lambda: p_engine.prefill_extract_staged(
                req, plane, on_ticket=tickets.append))
        assert len(tickets) == 1 and len(plane._staged) == 1
        staged = next(iter(plane._staged.values()))
        assert [n for n, _ in staged.groups] == [4, 4, 2]
        for _, resolve in staged.groups:  # dispatched or not, all fail
            with pytest.raises(RuntimeError, match="chunked prefill failed"):
                resolve()
        with pytest.raises((ConnectionError, OSError),
                           match="resolve failed"):
            await client.pull(tickets[0])
        # The pages were released: none is held.
        assert p_engine.allocator.num_active == 0
    finally:
        del runner.prefill_chunk_async
        client.close()
        plane.close()


@async_test(timeout=60)
async def test_adapter_requests_are_refused_on_extract(pair):
    request = dict(_wire(_prompt(23, 24), 4), adapter="a")
    req = PreprocessedRequest.from_wire(request)
    with pytest.raises(InvalidRequestError, match="adapter"):
        await pair[0].run_job(lambda: pair[0].prefill_extract(req))


def test_worker_cli_accepts_the_disagg_flags():
    args = gpu.parse_args(["--mode", "prefill"])
    assert (args.mode, args.prefill_component, args.kv_plane_host,
            args.no_kv_plane) == ("prefill", None, "127.0.0.1", False)
    args = gpu.parse_args([
        "--mode", "decode", "--max-local-prefill-length", "2048",
        "--prefill-dispatch", "queue", "--max-prefill-queue-depth", "4",
        "--prefill-component", "pf", "--kv-plane-host", "10.0.0.2"])
    assert (args.max_local_prefill_length, args.prefill_dispatch,
            args.max_prefill_queue_depth, args.prefill_component,
            args.kv_plane_host) == (2048, "queue", 4, "pf", "10.0.0.2")
    assert gpu.parse_args(["--no-kv-plane"]).no_kv_plane
    assert gpu.parse_args([]).max_local_prefill_length == 512
    with pytest.raises(SystemExit):
        gpu.parse_args(["--prefill-dispatch", "queue", "--no-kv-plane"])


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "inline"])
def test_1p1d_entry_points_as_processes(plane):
    """coordinator + ``--mode prefill`` + ``--mode decode`` + frontend,
    each a process on the CPU: a streamed chat over the threshold is
    prefilled on the prefill worker, and all four exit 0 on SIGTERM; the
    workers log their plane's device path off (a CPU engine) and print
    their counters as they exit."""
    procs = []
    try:
        coord = Proc("dynamo_tpu_torch.runtime.coordinator", "--host",
                     "127.0.0.1", "--port", "0")
        procs.append(coord)
        url = f"tcp://127.0.0.1:{coord.port('COORDINATOR_READY')}"
        common = ("--model", "tiny-test", "--device", "cpu", "--num-pages",
                  "64", "--coordinator-url", url)
        extra = () if plane else ("--no-kv-plane",)
        prefill = Proc("dynamo_tpu_torch.backends.gpu", "--mode", "prefill",
                       *common, *extra)
        decode = Proc("dynamo_tpu_torch.backends.gpu", "--mode", "decode",
                      "--max-local-prefill-length", "8", *common)
        front = Proc("dynamo_tpu_torch.frontend", "--http-host",
                     "127.0.0.1", "--http-port", "0", "--coordinator-url",
                     url)
        procs += [prefill, decode, front]
        assert prefill.wait_line("GPU_WORKER_READY").startswith(
            "GPU_WORKER_READY mode=prefill port=")
        assert decode.wait_line("GPU_WORKER_READY").startswith(
            "GPU_WORKER_READY mode=decode port=")
        fport = front.port("FRONTEND_READY")
        deadline = time.monotonic() + 60
        while b'"tiny-test"' not in _models(fport):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        status, ctype, raw = _call(fport, "POST", "/v1/chat/completions",
                                   _stream_chat("the quick brown fox"))
        assert (status, ctype) == (200, "text/event-stream")
        assert sse_events(raw)[-1]["usage"]["completion_tokens"] == 8
        prefill.wait_line("chunk-streamed" if plane else "sent inline")
        if plane:
            assert "device path off: the engine runs on cpu" in \
                prefill.wait_line("KV plane device path")
        # SIGUSR1 prints the same counters while the worker serves on.
        decode.p.send_signal(signal.SIGUSR1)
        mid = json.loads(decode.wait_line("GPU_WORKER_COUNTERS ").split(
            " ", 1)[1])
        assert b'"tiny-test"' in _models(fport)
        for proc in (front, decode, prefill, coord):
            assert proc.stop() == 0, proc.seen[-20:]
        counters = json.loads(decode.wait_line("GPU_WORKER_EXIT ").split(
            " ", 1)[1])
        assert (mid["engine"], mid["disagg"]) == (counters["engine"],
                                                  counters["disagg"])
        assert counters["engine"]["windows"] > 0
        assert counters["disagg"] == {"remote_prefills": 1,
                                      "local_prefills": 0,
                                      "remote_failures": 0}
        assert counters["engine"]["injected_admissions"] == 1
        client = counters["plane_client"]
        assert (client["socket_pulls"], client["device_pulls"]) == (
            (1, 0) if plane else (0, 0))
        done = json.loads(prefill.wait_line("GPU_WORKER_EXIT ").split(
            " ", 1)[1])
        assert done["engine"]["windows"] == 0
        assert ("plane_server" in done) == plane
    finally:
        for proc in procs:
            proc.kill()
