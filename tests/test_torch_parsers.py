"""The tool-call and reasoning parsers in the port
(``dynamo_tpu_torch.llm.parsers`` and the chat path that applies them)
against the JAX package's, on the CPU.

- Every case of ``tests/test_parsers.py`` runs over both modules (the
  delta-generator case over both packages' ``ChatDeltaGenerator``).
- The batch and streaming parsers give the same outputs for the same
  texts, for every name in ``TOOL_FORMATS`` and ``REASONING_FORMATS``.
- ``ChatDeltaGenerator`` and ``aggregate_chat_stream`` give the same
  chunks and the same aggregate as the JAX package's on the same
  ``LLMEngineOutput`` streams, for every pair of a tool-call format (or
  none) and a reasoning format (or none), with each text split in two at
  every offset and one character a delta. Call ids (random) and the
  chunks' ``id``/``created`` are left out of the comparison.
- The launcher's ``--tool-call-parser``/``--reasoning-parser`` reach its
  cards, and its pipeline's chunks equal the JAX pipeline's on the same
  detokenized stream. A worker process started with the flags registers
  a card that a JAX front's watcher and a port front's watcher both read
  with the parser names.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest
import test_parsers
from conftest import async_test
from test_torch_preprocessor import MODEL, ScriptedEngine

from dynamo_tpu.llm import backend as jbackend
from dynamo_tpu.llm import discovery as jdisc
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm import parsers as jparsers
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm import protocols as jproto
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.llm import discovery as tdisc
from dynamo_tpu_torch.llm import parsers as tparsers
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm import protocols as tproto
from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import distributed as tdist
from dynamo_tpu_torch.runtime.context import Context as TContext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {"jax": jparsers, "port": tparsers}
WEATHER = test_parsers.WEATHER
PARSER_NAMES = ("StreamingReasoningParser", "StreamingToolCallParser",
                "parse_reasoning", "parse_tool_calls")
REF_CASES = sorted(n for n in dir(test_parsers) if n.startswith("test_"))


def test_formats_are_the_reference_formats():
    assert tparsers.REASONING_FORMATS == jparsers.REASONING_FORMATS
    assert set(tparsers.TOOL_FORMATS) == set(jparsers.TOOL_FORMATS)
    for name, fmt in jparsers.TOOL_FORMATS.items():
        port = tparsers.TOOL_FORMATS[name]
        assert (port.start_tokens, port.end_tokens, port.bare_json_ok) == \
            (fmt.start_tokens, fmt.end_tokens, fmt.bare_json_ok), name


@pytest.mark.parametrize("package", sorted(MODULES))
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_parser_cases(case, package, monkeypatch):
    """``tests/test_parsers.py``'s case run with ``package``'s parsers
    (and, for the delta-generator case, its ``ChatDeltaGenerator``)."""
    for name in PARSER_NAMES:
        monkeypatch.setattr(test_parsers, name,
                            getattr(MODULES[package], name))
    if package == "port":
        monkeypatch.setattr(jpre, "ChatDeltaGenerator",
                            tpre.ChatDeltaGenerator)
    getattr(test_parsers, case)()


def _payload(fmt: str | None) -> str:
    return {
        "hermes": f"<tool_call>{WEATHER}\n</tool_call>",
        "nemotron_deci": f"<TOOLCALL>[{WEATHER}]</TOOLCALL>",
        "llama3_json": f"<|python_tag|>{WEATHER}",
        "mistral": f"[TOOL_CALLS][{WEATHER}, {WEATHER}]",
        "phi4": f"functools[{WEATHER}]",
        "default": f"<TOOLCALL>[{WEATHER}]</TOOLCALL>",
    }.get(fmt, f"<tool_call>{WEATHER}</tool_call>")


def _texts(tool: str | None) -> list[str]:
    payload = _payload(tool)
    return [f"<think>step 1\nstep 2</think>Sure! {payload}",
            f"chain of thought</think>{payload}",
            "plain a < b, <thin and [TOOL and funct> text",
            f"{WEATHER} trailing"]


def _strip_ids(value):
    """``value`` without tool-call ids (random) and chunk ids/created."""
    if isinstance(value, dict):
        return {k: _strip_ids(v) for k, v in value.items()
                if k not in ("id", "created")}
    if isinstance(value, list | tuple):
        return [_strip_ids(v) for v in value]
    if isinstance(value, tparsers.ToolCall | jparsers.ToolCall):
        return (value.name, value.arguments)
    return value


FORMAT_PAIRS = [(t, r) for t in (None, *sorted(jparsers.TOOL_FORMATS))
                for r in (None, *sorted(jparsers.REASONING_FORMATS))]


@pytest.mark.parametrize("tool,reasoning", FORMAT_PAIRS)
def test_batch_and_streaming_parsers_agree(tool, reasoning):
    for text in _texts(tool):
        outs = {}
        for pkg, mod in MODULES.items():
            got = [mod.parse_tool_calls(text, tool),
                   mod.parse_reasoning(text, reasoning)]
            for k in range(len(text) + 1):
                tp = mod.StreamingToolCallParser(tool)
                rp = mod.StreamingReasoningParser(reasoning)
                got.append(([tp.feed(text[:k]), tp.feed(text[k:])],
                            tp.finish()))
                got.append(([rp.feed(text[:k]), rp.feed(text[k:])],
                            rp.finish()))
            outs[pkg] = _strip_ids(got)
        assert outs["port"] == outs["jax"], text


def _splits(text: str) -> list[list[str]]:
    """Every two-piece split of ``text``, and one character a piece."""
    return [[text[:k], text[k:]] for k in range(len(text) + 1)] + [
        list(text)]


async def _generator_run(pkg: str, pieces: list[str], tool, reasoning):
    """(chunks, aggregate) of ``pkg``'s delta generator over one stream."""
    proto = jproto if pkg == "jax" else tproto
    pre = jpre if pkg == "jax" else tpre
    req = proto.ChatCompletionRequest.model_validate({
        "model": MODEL, "messages": [{"role": "user", "content": "hi"}],
        "stream_options": {"include_usage": True}})
    gen = pre.ChatDeltaGenerator(req, prompt_tokens=3,
                                 tool_call_parser=tool,
                                 reasoning_parser=reasoning)
    chunks = []
    for i, text in enumerate(pieces):
        chunks.extend(gen.step(proto.LLMEngineOutput(
            token_ids=[i], text=text,
            finish_reason=(proto.FinishReason.EOS if i == len(pieces) - 1
                           else None))))

    async def replay():
        for c in chunks:
            yield c
    full = await pre.aggregate_chat_stream(replay(), 3)
    return chunks, full


@pytest.mark.parametrize("tool,reasoning", FORMAT_PAIRS)
@async_test
async def test_chat_chunks_and_aggregate_match_at_every_split(tool,
                                                              reasoning):
    for text in _texts(tool):
        for pieces in _splits(text):
            j = await _generator_run("jax", pieces, tool, reasoning)
            t = await _generator_run("port", pieces, tool, reasoning)
            assert _strip_ids(t) == _strip_ids(j), pieces


def _tagged_script() -> list[dict]:
    """Engine items whose detokenized text has a think block and a hermes
    tool call, three token ids an item."""
    tok = make_test_tokenizer()
    ids = tok.encode(f"<think>let me check</think>Sure! <tool_call>"
                     f"{WEATHER}\n</tool_call>")
    items = [{"token_ids": ids[k:k + 3]} for k in range(0, len(ids), 3)]
    items[-1]["finish_reason"] = "stop"
    return items


@pytest.mark.parametrize("stream", [True, False])
@async_test
async def test_launcher_cards_carry_the_parsers(stream):
    engine = ScriptedEngine(_tagged_script())
    args = launch.parse_args(["--model", MODEL, "--device", "cpu",
                              "--tool-call-parser", "hermes",
                              "--reasoning-parser", "basic"])
    served, _ = launch.build_local_served(args, engine=engine)
    card = served.entry.card
    assert (card.tool_call_parser, card.reasoning_parser) == ("hermes",
                                                              "basic")
    jcard_ = jcard.ModelDeploymentCard(name=MODEL, context_length=8192,
                                       tool_call_parser="hermes",
                                       reasoning_parser="basic")
    jp = jpre.OpenAIPreprocessor(jcard_, j_test_tokenizer(),
                                 jbackend.Backend(j_test_tokenizer(), engine))
    body = {"model": MODEL, "messages": [{"role": "user", "content": "hi"}],
            "stream": stream, "stream_options": {"include_usage": True}}
    j_chunks = [c async for c in jp.generate(
        jproto.ChatCompletionRequest.model_validate(body), JContext())]
    t_chunks = [c async for c in served.preprocessor.generate(
        tproto.ChatCompletionRequest.model_validate(body), TContext())]
    assert _strip_ids(t_chunks) == _strip_ids(j_chunks)
    finish = [c["choices"][0]["finish_reason"] for c in t_chunks
              if c.get("choices") and c["choices"][0]["finish_reason"]]
    assert finish == ["tool_calls"]
    if not stream:
        async def replay(chunks):
            for c in chunks:
                yield c
        t_full = await tpre.aggregate_chat_stream(replay(t_chunks), 3)
        j_full = await jpre.aggregate_chat_stream(replay(j_chunks), 3)
        assert _strip_ids(t_full) == _strip_ids(j_full)
        message = t_full["choices"][0]["message"]
        assert message["reasoning_content"] == "let me check"
        assert message["content"] == "Sure! "
        assert message["tool_calls"][0]["function"]["name"] == "get_weather"


@async_test(timeout=120)
async def test_worker_card_names_its_parsers_to_both_fronts():
    """``python -m dynamo_tpu_torch.backends.gpu --tool-call-parser hermes
    --reasoning-parser deepseek_r1`` registers a card that a JAX and a port
    ``ModelWatcher`` read with both names."""
    coord = tcoord.Coordinator("127.0.0.1", 0)
    await coord.start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.backends.gpu", "--model",
         MODEL, "--device", "cpu", "--num-pages", "16", "--coordinator-url",
         coord.url, "--tool-call-parser", "hermes", "--reasoning-parser",
         "deepseek_r1"], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, env=dict(os.environ, OMP_NUM_THREADS="1"))
    stops = []
    try:
        j_rt = await jdist.DistributedRuntime.from_settings(
            jconfig.RuntimeConfig(coordinator_url=coord.url))
        jm = jdisc.ModelManager()
        jw = jdisc.ModelWatcher(j_rt, jm)
        await jw.start()
        stops += [j_rt.close, jw.stop]
        t_rt = await tdist.DistributedRuntime.from_settings(
            tconfig.RuntimeConfig(coordinator_url=coord.url))
        tm = tdisc.ModelManager()
        tw = tdisc.ModelWatcher(t_rt, tm)
        await tw.start()
        stops += [t_rt.close, tw.stop]
        for _ in range(3000):
            if jm.get(MODEL) is not None and tm.get(MODEL) is not None:
                break
            assert proc.poll() is None, proc.returncode
            await asyncio.sleep(0.02)
        for manager in (jm, tm):
            card = manager.get(MODEL).entry.card
            assert (card.tool_call_parser, card.reasoning_parser) == (
                "hermes", "deepseek_r1")
        raw = await t_rt.require_coordinator().kv_get_prefix("models/")
        assert json.dumps(raw).count('"tool_call_parser": "hermes"') == 1
    finally:
        proc.terminate()
        await asyncio.to_thread(proc.wait, 30)
        for stop in reversed(stops):
            await stop()
        await coord.stop()
