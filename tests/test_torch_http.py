"""The port's HTTP front (``dynamo_tpu_torch.llm.http_service``) and its
launcher (``python -m dynamo_tpu_torch.launch in=http out=gpu``) against
the JAX package's.

- The JAX ``HttpService`` and the port's, each over a local served model
  on the same scripted engine, give equal statuses, ``Content-Type``, SSE
  framing and JSON bodies (modulo ``id``/``created``) for chat and
  completions, streamed and not, ``/v1/models`` and the error cases. The
  400 for a body without ``messages`` is compared by status and error
  shape: its message is pydantic's text in the reference.
- A client that disconnects mid-stream leaves the request's context
  killed.
- The slice as a whole: a JAX ``TPUEngine`` and a port ``GPUEngine`` on
  tiny-test with the same params, each behind its own package's front,
  give the same ``prompt_tokens`` and the same greedy tokens wherever the
  reference's top-2 margin exceeds a bf16 ulp (the rule of
  ``test_torch_engine.py``), on bf16 and on int8 pools. Tokens are read
  through a tap on each engine, not through text, which hides ids outside
  the test tokenizer's vocab.
- The launcher as a subprocess on the CPU: ``LAUNCH_READY``, a streamed
  chat, ``/v1/models``, exit 0 on SIGTERM.

Every server binds 127.0.0.1 port 0, and every wait has its own timeout.
"""

import asyncio
import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from conftest import async_test
from test_torch_engine import (ENGINE_KW, SPEC_J, SPEC_T, _bf16_ulp,
                               _ref_int8_logits, _ref_logits)
from test_torch_preprocessor import (MODEL, ScriptedEngine, _script, chat,
                                     completion, pipelines, strip_ids)

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import backend as jbackend
from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm.http_service import HttpService as JHttpService
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime.config import RuntimeConfig
from dynamo_tpu.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm.http_service import HttpService as THttpService
from dynamo_tpu_torch.runtime.engine import AsyncEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60


def _call(port, method, path, body=None):
    """(status, Content-Type, body bytes) through http.client."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        payload = body if isinstance(body, (bytes, type(None))) \
            else json.dumps(body).encode()
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


async def call(port, method, path, body=None):
    return await asyncio.to_thread(_call, port, method, path, body)


def sse_events(raw: bytes) -> list:
    """The events of an SSE body, each ``data: <json>`` parsed; asserts the
    framing (``data: `` lines, blank-line separated, ``[DONE]`` last)."""
    text = raw.decode()
    assert text.endswith("\n\n"), text[-50:]
    events = text[:-2].split("\n\n")
    assert all(e.startswith("data: ") for e in events), events
    assert events[-1] == "data: [DONE]"
    return [json.loads(e[len("data: "):]) for e in events[:-1]]


def _j_served(pre):
    entry = jcard.ModelEntry(model_name=MODEL, namespace="local",
                             component="local", endpoint="generate",
                             model_type="chat", card=pre.card)
    return jdisc.ServedModel(entry, pre, client=None, router=None)


def _t_served(pre):
    entry = tcard.ModelEntry(model_name=MODEL, namespace="local",
                             component="local", endpoint="generate",
                             model_type="chat", card=pre.card)
    return tdisc.ServedModel(entry, pre)


async def _fronts(j_served, t_served):
    """Start the JAX and the port front; returns (ports, stop)."""
    runtime = await DistributedRuntime.detached(RuntimeConfig())
    jm, tm = jdisc.ModelManager(), tdisc.ModelManager()
    jm.models[j_served.name] = j_served
    tm.models[t_served.name] = t_served
    jsvc = JHttpService(runtime, jm, host="127.0.0.1", port=0)
    tsvc = THttpService(tm, host="127.0.0.1", port=0)
    await jsvc.start()
    await tsvc.start()

    async def stop():
        await tsvc.stop()
        await jsvc.stop()
        await runtime.close()
    return (jsvc.port, tsvc.port), stop


CASES = [
    ("POST", "/v1/chat/completions",
     chat(stream=True, stream_options={"include_usage": True})),
    ("POST", "/v1/chat/completions", chat(stream=True, stop=["brown f"])),
    ("POST", "/v1/chat/completions", chat()),
    ("POST", "/v1/chat/completions", chat(logprobs=True, top_logprobs=2)),
    ("POST", "/v1/completions",
     completion(stream=True, stream_options={"include_usage": True})),
    ("POST", "/v1/completions", completion(prompt=[5, 6, 7])),
    ("POST", "/v1/completions", completion(logprobs=2, stop="fox")),
    ("GET", "/v1/models", None),
    ("POST", "/v1/chat/completions", b"{not json"),
    ("POST", "/v1/chat/completions", b""),
    ("POST", "/v1/chat/completions", chat(model="nope")),
    ("POST", "/v1/completions", completion(model="nope")),
    ("POST", "/v1/completions", completion(prompt=["a", "b"])),
]


@async_test(timeout=120)
async def test_fronts_answer_alike():
    script = _script("length", logprobs=True)
    jp, tp = pipelines(ScriptedEngine(script))
    (jport, tport), stop = await _fronts(_j_served(jp), _t_served(tp))
    try:
        for method, path, body in CASES:
            j = await call(jport, method, path, body)
            t = await call(tport, method, path, body)
            assert t[:2] == j[:2], (path, body, t[:2], j[:2])
            if j[1] == "text/event-stream":
                assert strip_ids(sse_events(t[2])) == \
                    strip_ids(sse_events(j[2])), body
            else:
                assert strip_ids([json.loads(t[2])]) == \
                    strip_ids([json.loads(j[2])]), (body, t[2], j[2])
        # A body without messages: the same status and error shape; the
        # reference's message is pydantic's own text.
        j = await call(jport, "POST", "/v1/chat/completions",
                       {"model": MODEL})
        t = await call(tport, "POST", "/v1/chat/completions",
                       {"model": MODEL})
        assert t[:2] == j[:2] and t[0] == 400
        jerr, terr = json.loads(j[2])["error"], json.loads(t[2])["error"]
        assert "messages" in jerr["message"] and \
            "messages" in terr["message"]
        assert {k: v for k, v in terr.items() if k != "message"} == \
            {k: v for k, v in jerr.items() if k != "message"}
        for path in ("/health", "/live"):
            j = await call(jport, "GET", path)
            t = await call(tport, "GET", path)
            assert (t[0], json.loads(t[2])) == (j[0], json.loads(j[2]))
    finally:
        await stop()


@async_test(timeout=120)
async def test_client_disconnect_kills_the_context():
    engine = ScriptedEngine(_script("length"), hold_after=2)
    _, tp = pipelines(engine)
    manager = tdisc.ModelManager()
    manager.models[MODEL] = _t_served(tp)
    svc = THttpService(manager, host="127.0.0.1", port=0)
    await svc.start()
    try:
        body = json.dumps(chat(stream=True)).encode()
        reader, writer = await asyncio.open_connection("127.0.0.1", svc.port)
        writer.write(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                      TIMEOUT_S)
        assert head.startswith(b"HTTP/1.1 200")
        first = await asyncio.wait_for(reader.readuntil(b"\n\n"), TIMEOUT_S)
        assert first.startswith(b"data: {")
        writer.close()
        ctx = engine.seen[-1][1]
        for _ in range(TIMEOUT_S * 20):
            if ctx.is_killed:
                break
            await asyncio.sleep(0.05)
        assert ctx.is_killed
    finally:
        await svc.stop()


# -- the slice as a whole -----------------------------------------------------

class Tap(AsyncEngine):
    """Passes an engine's stream through and records the request's token
    ids and every emitted token id."""

    def __init__(self, engine):
        self.engine = engine
        self.tokens: dict[tuple, list] = {}  # prompt ids -> emitted ids

    async def generate(self, request, context):
        wire = request if isinstance(request, dict) else request.to_wire()
        tokens = self.tokens[tuple(wire["token_ids"])] = []
        async for item in self.engine.generate(request, context):
            tokens.extend(item.get("token_ids", []))
            yield item


@pytest.mark.parametrize("quant_kv", [None, "int8"])
@async_test(timeout=300)
async def test_greedy_chat_through_both_fronts(quant_kv):
    jparams = jmodel.init_params(SPEC_J, jax.random.key(44))
    jeng = TPUEngine(jcfg.EngineConfig(
        model=SPEC_J, attention_backend="xla", quant_kv=quant_kv,
        **ENGINE_KW), params=jparams)
    teng = GPUEngine(tcfg.EngineConfig(
        model=SPEC_T, device="cpu", quant_kv=quant_kv, **ENGINE_KW),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), SPEC_T,
                               device="cpu"))
    jtap, ttap = Tap(jeng), Tap(teng)
    args = launch.parse_args(["--model", "tiny-test", "--device", "cpu",
                              "--context-length", "512"])
    t_served, _ = launch.build_local_served(args, engine=ttap)
    jcard_ = jcard.ModelDeploymentCard(
        name=MODEL, chat_template=jcard.DEFAULT_CHAT_TEMPLATE,
        context_length=512)
    jtok = j_test_tokenizer()
    j_served = _j_served(jpre.OpenAIPreprocessor(
        jcard_, jtok, jbackend.Backend(jtok, jtap)))
    (jport, tport), stop = await _fronts(j_served, t_served)
    try:
        contents = ["the quick brown fox jumps over the dog",
                    "hello world", "def main(): return 0123456789"]
        bodies = [chat(messages=[{"role": "user", "content": c}],
                       max_tokens=8, ignore_eos=True, stream=True,
                       stream_options={"include_usage": True})
                  for c in contents]
        js = await asyncio.gather(*[call(jport, "POST",
                                         "/v1/chat/completions", b)
                                    for b in bodies])
        ts = await asyncio.gather(*[call(tport, "POST",
                                         "/v1/chat/completions", b)
                                    for b in bodies])
        usages = []
        for j, t in zip(js, ts):
            assert j[0] == t[0] == 200
            usages.append(sse_events(t[2])[-1]["usage"])
            assert usages[-1] == sse_events(j[2])[-1]["usage"]
            assert usages[-1]["completion_tokens"] == 8
        # Both engines got the same prompts, of the counted lengths.
        assert jtap.tokens.keys() == ttap.tokens.keys()
        assert sorted(map(len, jtap.tokens)) == sorted(
            u["prompt_tokens"] for u in usages)
        compared = 0
        for prompt, rt in jtap.tokens.items():
            prompt, gt = list(prompt), ttap.tokens[prompt]
            assert len(rt) == len(gt) == 8
            for i, (a, b) in enumerate(zip(rt, gt)):
                if a == b:
                    compared += 1
                    continue
                logits = (_ref_logits(jparams, prompt + rt[:i])
                          if not quant_kv else
                          _ref_int8_logits(jparams, prompt, rt[:i + 1])[i])
                top2 = np.sort(logits)[-2:]
                margin = float(top2[1] - top2[0])
                assert margin <= _bf16_ulp(top2[1]), (
                    f"token {i}: port {b} != reference {a} at a clear "
                    f"margin {margin:.4f}")
                break  # a legitimate near-tie split: the chains diverge
        assert compared >= 8
    finally:
        await stop()
        jeng.stop()
        teng.stop()


# -- the launcher -------------------------------------------------------------

def test_launcher_refuses_inputs_of_later_slices(capsys):
    # in=text and in=batch are served since the inputs slice
    # (test_torch_launch_inputs.py); in=batch still needs its file.
    assert launch.parse_args(["in=text"]).input == "text"
    assert launch.parse_args(["in=batch", "--input-file", "p.jsonl"]) \
        .input == "batch"
    for argv, word in ((["in=grpc"], "gRPC"),
                       (["in=batch"], "in=batch requires --input-file"),
                       (["out=tpu"], "out= must be gpu or dyn")):
        with pytest.raises(SystemExit):
            launch.parse_args(argv)
        assert word in capsys.readouterr().err
    args = launch.parse_args([])
    assert (args.input, args.output, args.device) == ("http", "gpu", "cuda")
    # out=dyn is served since the worker-main slice (test_torch_worker.py).
    assert launch.parse_args(["out=dyn"]).output == "dyn"


def test_launcher_serves_and_exits_on_sigterm():
    env = dict(os.environ, OMP_NUM_THREADS="1", DTPU_LOG="warning")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.launch", "in=http",
         "out=gpu", "--model", "tiny-test", "--device", "cpu",
         "--num-pages", "64", "--http-port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        line = ""
        while not line.startswith("LAUNCH_READY"):
            line = lines.get(timeout=TIMEOUT_S)
        assert line.startswith("LAUNCH_READY in=http out=gpu port=")
        port = int(line.strip().rsplit("=", 1)[1])
        status, ctype, raw = _call(port, "POST", "/v1/chat/completions", chat(
            stream=True, max_tokens=6, ignore_eos=True,
            stream_options={"include_usage": True}))
        assert (status, ctype) == (200, "text/event-stream")
        events = sse_events(raw)
        assert events[-1]["usage"]["completion_tokens"] == 6
        assert events[-2]["choices"][0]["finish_reason"] == "length"
        status, _, raw = _call(port, "GET", "/v1/models")
        assert status == 200
        assert [m["id"] for m in json.loads(raw)["data"]] == ["tiny-test"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT_S) == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        proc.stderr.close()
