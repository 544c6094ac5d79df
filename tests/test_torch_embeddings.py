"""Embeddings in the port (``model.embed_forward``, ``runner.embed``,
``GPUEngine.embed`` and its handlers, ``/v1/embeddings``) against the JAX
package's, on the CPU.

- ``embed_forward`` on the same weights and a padded batch (lengths 1, 7
  and 33 and one padding row, token 0 and length 1, in a batch of 4), for
  ``last`` and ``mean`` pooling, bf16 and int8 (``QTensor``) weights, on
  tiny-test and a narrow two-layer spec with GQA and a qkv bias. Both
  give unit vectors; they agree within ``ABS_TOL`` per component and at
  cosine >= ``COS_MIN`` (bf16 activations rounded in another summation
  order, as ``test_torch_model``'s logits are).
- ``runner.embed`` against the JAX ``ModelRunner.embed``: the same
  vectors within the same tolerance, and the same refusals with the same
  messages.
- The engine's embed job runs between the windows of greedy requests,
  whose tokens stay those served without it; the aggregated handler and
  the disaggregated decode handler answer ``embed`` with one
  ``embeddings`` item.
- A mixed fleet both ways: a JAX front asks a port worker, and a port
  front asks a JAX worker, over one coordinator; the vectors agree with
  the other package's engine within the tolerance.
- Over HTTP the port's launcher front and the JAX launcher's answer the
  cases of ``tests/test_wide_components.py``'s embeddings test, and the
  other inputs and errors of the route, with the same statuses and bodies
  (vectors within the tolerance), and 503 with ``Retry-After`` when a
  routed model has no worker.
"""

import asyncio
import http.client
import json

import jax
import numpy as np
import pytest
import torch
from conftest import async_test
from test_torch_engine import ENGINE_KW, SPEC_J, SPEC_T
from test_torch_model import TINY_QWEN

from dynamo_tpu import launch as jlaunch
from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import quant as jq
from dynamo_tpu.engine import runner as jrunner
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm.http_service import HttpService as JHttpService
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JPre
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu.runtime.errors import NoInstancesError as JNoInstances
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm.http_service import HttpService as THttpService
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor as TPre
from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import distributed as tdist
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import NoInstancesError

torch.set_num_threads(1)

ABS_TOL = 1e-2     # per component of the unit vectors
COS_MIN = 0.9995   # cosine between the port's vector and the reference's
MODEL = "tiny-test"
TIMEOUT_S = 60
LEASE_TTL_S = 2.0


def _specs(kind):
    if kind == "tiny-test":
        return SPEC_J, SPEC_T
    return jcfg.ModelSpec(**TINY_QWEN), tcfg.ModelSpec(**TINY_QWEN)


def _trees(kind, quant):
    """(jspec, tspec, JAX params, port params) on the same weights."""
    jspec, tspec = _specs(kind)
    jparams = jax.tree.map(np.asarray, jmodel.init_params(
        jspec, jax.random.key(7)))
    if quant:
        jparams = jq.quantize_params(jparams)
    return jspec, tspec, jparams, params_from_jax(jparams, tspec,
                                                  device="cpu")


def assert_close(got, want):
    """Unit vectors [n, H] within ABS_TOL per component and COS_MIN."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=ABS_TOL, rtol=0)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= COS_MIN, cos


def _padded_batch(vocab):
    rng = np.random.default_rng(11)
    lens = np.array([1, 7, 33, 1], np.int32)  # the last row pads the batch
    toks = np.zeros((4, 64), np.int32)
    for i, n in enumerate(lens[:3]):
        toks[i, :n] = rng.integers(1, vocab, n)
    return toks, lens


@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("pooling", ["last", "mean"])
@pytest.mark.parametrize("kind", ["tiny-test", "tiny-qwen"])
def test_embed_forward_matches_reference(kind, pooling, quant):
    jspec, tspec, jparams, tparams = _trees(kind, quant)
    toks, lens = _padded_batch(jspec.vocab_size)
    want = np.asarray(jax.jit(lambda p, t, s: jmodel.embed_forward(
        p, jspec, t, s, pooling=pooling))(jparams, toks, lens))
    got = tmodel.embed_forward(tparams, tspec, torch.from_numpy(toks),
                               torch.from_numpy(lens), pooling=pooling)
    assert got.dtype == torch.float32 and got.shape == (4, tspec.hidden_size)
    assert_close(got.numpy(), want)


@pytest.fixture(scope="module")
def runners():
    _, _, jparams, tparams = _trees("tiny-test", None)
    jr = jrunner.ModelRunner(jcfg.EngineConfig(
        model=SPEC_J, attention_backend="xla", **ENGINE_KW), params=jparams)
    tr = trunner.ModelRunner(tcfg.EngineConfig(
        model=SPEC_T, device="cpu", **ENGINE_KW), params=tparams)
    return jr, tr


@pytest.mark.parametrize("pooling", ["last", "mean"])
def test_runner_embed_matches_reference(runners, pooling):
    jr, tr = runners
    rng = np.random.default_rng(3)
    lists = [rng.integers(1, SPEC_T.vocab_size, n).tolist()
             for n in (5, 1, 40, 17, 256)]
    got = tr.embed(lists, pooling)
    assert got.dtype == np.float32 and got.shape == (5, SPEC_T.hidden_size)
    assert_close(got, jr.embed(lists, pooling))
    # A row embedded alone equals its row of the padded batch.
    alone = tr.embed([lists[2]], pooling)
    np.testing.assert_allclose(alone[0], got[2], atol=1e-2)


@pytest.mark.parametrize("lists", [[], [[1, 2], []], [list(range(1, 258))]],
                         ids=["no-input", "empty-input", "over-bucket"])
def test_runner_embed_refusals_match_reference(runners, lists):
    jr, tr = runners
    with pytest.raises(ValueError) as want:
        jr.embed(lists)
    with pytest.raises(ValueError) as got:
        tr.embed(lists)
    assert str(got.value) == str(want.value)


def _engine(params=None):
    if params is None:
        params = _trees("tiny-test", None)[3]
    engine = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                         **ENGINE_KW), params=params, seed=0)
    engine.start()
    return engine


async def _greedy(engine, prompts, max_tokens=24):
    async def one(p):
        toks = []
        async for out in engine.generate(
                {"model": MODEL, "token_ids": p,
                 "stop_conditions": {"max_tokens": max_tokens,
                                     "ignore_eos": True},
                 "sampling_options": {"temperature": 0.0}}, Context()):
            toks.extend(out.get("token_ids", []))
        return toks
    return await asyncio.gather(*[one(p) for p in prompts])


@async_test(timeout=120)
async def test_engine_embed_between_windows_leaves_decode_unchanged():
    engine = _engine()
    try:
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, SPEC_T.vocab_size, n).tolist()
                   for n in (9, 30, 50)]
        lists = [rng.integers(1, SPEC_T.vocab_size, n).tolist()
                 for n in (3, 64, 12)]
        alone = await _greedy(engine, prompts)
        windows0 = engine.windows_dispatched
        decode = asyncio.ensure_future(_greedy(engine, prompts))
        vectors = []
        while not decode.done():
            vectors.append(await engine.embed(lists, "mean"))
            await asyncio.sleep(0)
        assert await decode == alone
        assert engine.windows_dispatched > windows0
        want = engine.runner.embed(lists, "mean")
        for v in vectors:
            np.testing.assert_array_equal(np.asarray(v, np.float32), want)
    finally:
        engine.stop()


@async_test(timeout=120)
async def test_handlers_answer_embed():
    """``GPUEngine.handler`` and ``DisaggDecodeHandler.handler`` answer an
    ``embed`` request with one ``embeddings`` item, the engine's own."""
    from dynamo_tpu_torch.llm.disagg import (DisaggDecodeHandler,
                                             DisaggRouterConfig)
    engine = _engine()
    try:
        request = {"embed": True, "token_lists": [[5, 6, 7], [9]],
                   "pooling": "last"}
        want = await engine.embed(request["token_lists"], "last")
        decode = DisaggDecodeHandler(engine, None, DisaggRouterConfig())
        for handle in (engine.handler(), decode.handler()):
            items = [i async for i in handle(dict(request), Context())]
            assert items == [{"embeddings": want}]
        # pooling defaults to "last", as in the reference.
        items = [i async for i in engine.handler()(
            {"embed": True, "token_lists": [[5, 6, 7], [9]]}, Context())]
        assert items == [{"embeddings": want}]
    finally:
        engine.stop()


# -- HTTP -----------------------------------------------------------------

def _call(port, body, raw=False):
    """(status, JSON body, Retry-After) of a POST /v1/embeddings."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        payload = body if raw else json.dumps(body).encode()
        conn.request("POST", "/v1/embeddings", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return (resp.status, json.loads(resp.read()),
                resp.getheader("Retry-After"))
    finally:
        conn.close()


async def post(port, body, raw=False):
    return await asyncio.to_thread(_call, port, body, raw)


def assert_same_answer(got, want):
    """Equal statuses, headers and bodies; vectors within the tolerance."""
    assert got[0] == want[0] and got[2] == want[2], (got, want)
    gb, wb = got[1], want[1]
    if got[0] != 200:
        assert gb == wb
        return
    assert_close([d["embedding"] for d in gb["data"]],
                 [d["embedding"] for d in wb["data"]])
    strip = [dict(d, embedding=None) for d in gb["data"]]
    assert strip == [dict(d, embedding=None) for d in wb["data"]]
    assert {k: v for k, v in gb.items() if k != "data"} == \
        {k: v for k, v in wb.items() if k != "data"}


HTTP_CASES = [
    # tests/test_wide_components.py::test_embeddings_and_responses_http
    {"model": MODEL, "input": ["hello world", "goodbye"]},
    {"model": MODEL, "input": []},
    {"model": "nope", "input": "x"},
    # the route's other inputs and errors
    {"model": MODEL, "input": "the quick brown fox"},
    {"model": MODEL, "input": [5, 6, 7, 8]},
    {"model": MODEL, "input": [[5, 6, 7], [9, 10], "hello"]},
    {"model": MODEL, "input": "mean pooled words", "pooling": "mean"},
    {"model": MODEL, "input": [""]},
    {"model": MODEL, "input": [list(range(1, 300))]},
    {"model": MODEL},
    {"input": "x"},
    b"{not json",
]


@async_test(timeout=180)
async def test_http_embeddings_match_the_jax_launcher():
    jargs = jlaunch.parse_args(["in=http", "out=tpu", "--model", MODEL,
                                "--num-pages", "64", "--context-length",
                                "256"])
    j_runtime = await jdist.DistributedRuntime.detached(
        jconfig.RuntimeConfig())
    j_served, j_engine = jlaunch.build_local_served(jargs)
    jm = jdisc.ModelManager()
    jm.models[j_served.name] = j_served
    jsvc = JHttpService(j_runtime, jm, host="127.0.0.1", port=0)
    await jsvc.start()
    tparams = params_from_jax(jax.tree.map(
        np.asarray, j_engine.runner.params), SPEC_T, device="cpu")
    targs = launch.parse_args(["--model", MODEL, "--device", "cpu",
                               "--num-pages", "64", "--context-length",
                               "256", "--http-port", "0"])
    tsvc, t_engine = await launch.start_http(targs, engine=_engine(tparams))
    try:
        for body in HTTP_CASES:
            raw = isinstance(body, bytes)
            want = await post(jsvc.port, body, raw)
            got = await post(tsvc.port, body, raw)
            assert_same_answer(got, want)
        # The first case's checks in the reference's test.
        status, body, _ = await post(tsvc.port, HTTP_CASES[0])
        v0, v1 = (np.asarray(d["embedding"]) for d in body["data"])
        assert abs(np.linalg.norm(v0) - 1.0) < 1e-3
        assert body["usage"]["prompt_tokens"] > 0
        assert np.abs(v0 - v1).max() > 1e-4
    finally:
        await tsvc.stop()
        t_engine.stop()
        await jsvc.stop()
        j_engine.stop()
        await j_runtime.close()


class _NoWorkers:
    """A routed model's client whose every worker is gone."""

    def __init__(self, error):
        self.error = error

    async def round_robin(self, request):
        raise self.error("no instances of dynamo/gpu/generate")

    async def generate(self, request, context=None, mode=None,
                       instance_id=None):
        raise self.error("no instances of dynamo/gpu/generate")


@async_test(timeout=120)
async def test_http_embeddings_without_workers_answer_503():
    j_runtime = await jdist.DistributedRuntime.detached(
        jconfig.RuntimeConfig())
    jcard_ = jcard.ModelDeploymentCard(name=MODEL, context_length=256)
    jm, tm = jdisc.ModelManager(), tdisc.ModelManager()
    jm.models[MODEL] = jdisc.ServedModel(
        jcard.ModelEntry(model_name=MODEL, namespace="dynamo",
                         component="gpu", endpoint="generate",
                         model_type="chat", card=jcard_),
        JPre(jcard_, j_test_tokenizer()), client=_NoWorkers(JNoInstances),
        router=None)
    tcard_ = tcard.ModelDeploymentCard(name=MODEL, context_length=256)
    tm.models[MODEL] = tdisc.ServedModel(
        tcard.ModelEntry(model_name=MODEL, namespace="dynamo",
                         component="gpu", endpoint="generate",
                         model_type="chat", card=tcard_),
        TPre(tcard_, make_test_tokenizer()), client=_NoWorkers(
            NoInstancesError))
    jsvc = JHttpService(j_runtime, jm, host="127.0.0.1", port=0)
    tsvc = THttpService(tm, host="127.0.0.1", port=0)
    await jsvc.start()
    await tsvc.start()
    try:
        body = {"model": MODEL, "input": "hello"}
        want = await post(jsvc.port, body)
        got = await post(tsvc.port, body)
        assert want[0] == 503 and want[2] is not None
        assert_same_answer(got, want)
    finally:
        await tsvc.stop()
        await jsvc.stop()
        await j_runtime.close()


# -- mixed fleets -----------------------------------------------------------

async def _jax_front(url):
    rt = await jdist.DistributedRuntime.from_settings(
        jconfig.RuntimeConfig(coordinator_url=url, lease_ttl_s=LEASE_TTL_S))
    manager = jdisc.ModelManager()
    watcher = jdisc.ModelWatcher(rt, manager)
    await watcher.start()
    service = JHttpService(rt, manager, host="127.0.0.1", port=0)
    await service.start()
    return rt, service, watcher


async def _wait_model(manager):
    for _ in range(int(TIMEOUT_S / 0.02)):
        if manager.get(MODEL) is not None:
            return
        await asyncio.sleep(0.02)
    raise AssertionError("the model never appeared")


@async_test(timeout=240)
async def test_mixed_fleets_answer_embed_both_ways():
    """A JAX front asks a port worker and a port front asks a JAX worker
    (each over the same coordinator); each answer agrees with the other
    package's engine on the same weights. ``stops`` runs last in, first
    out: servers before their runtimes."""
    _, _, jparams, tparams = _trees("tiny-test", None)
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW), params=jparams)
    teng = _engine(tparams)
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    stops = []
    try:
        # port worker behind a JAX front
        t_rt = await tdist.DistributedRuntime.from_settings(
            tconfig.RuntimeConfig(coordinator_url=coord.url,
                                  lease_ttl_s=LEASE_TTL_S))
        server = await gpu.serve_engine(t_rt, teng, MODEL,
                                        make_test_tokenizer())
        stops += [t_rt.close, server.shutdown]
        jf_rt, jf_svc, jf_watch = await _jax_front(coord.url)
        stops += [jf_rt.close, jf_watch.stop, jf_svc.stop]
        await _wait_model(jf_watch.manager)
        body = {"model": MODEL, "input": ["hello world", [5, 6, 7]],
                "pooling": "mean"}
        status, got, _ = await post(jf_svc.port, body)
        assert status == 200, got
        lists = [j_test_tokenizer().encode("hello world"), [5, 6, 7]]
        assert_close([d["embedding"] for d in got["data"]],
                     await jeng.embed(lists, "mean"))
        assert got["usage"]["prompt_tokens"] == sum(map(len, lists))
        for stop in reversed(stops):
            await stop()
        stops = []
        # JAX worker behind a port front
        j_rt = await jdist.DistributedRuntime.from_settings(
            jconfig.RuntimeConfig(coordinator_url=coord.url,
                                  lease_ttl_s=LEASE_TTL_S))
        ep = j_rt.namespace("dynamo").component("tpu").endpoint("generate")
        j_server = await ep.serve_endpoint(jeng.handler(),
                                           graceful_shutdown=False)
        await jcard.register_llm(j_rt, ep, MODEL, j_test_tokenizer(),
                                 context_length=256)
        stops += [j_rt.close, j_server.shutdown]
        f_rt = await tdist.DistributedRuntime.from_settings(
            tconfig.RuntimeConfig(coordinator_url=coord.url,
                                  lease_ttl_s=LEASE_TTL_S))
        service, watcher = await launch.start_front(f_rt, "127.0.0.1", 0)
        stops += [f_rt.close, watcher.stop, service.stop]
        await _wait_model(watcher.manager)
        status, got, _ = await post(service.port, body)
        assert status == 200, got
        assert_close([d["embedding"] for d in got["data"]],
                     await teng.embed(lists, "mean"))
    finally:
        for stop in reversed(stops):
            await stop()
        teng.stop()
        jeng.stop()
        await coord.stop()
