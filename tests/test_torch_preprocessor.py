"""The port's OpenAI preprocessor, chat template and detokenizing backend
against the JAX package's, on the test tokenizer.

- ``PreprocessedRequest.to_wire()`` of a table of chat and completion
  bodies equals the JAX preprocessor's.
- The chat template rendered without jinja2 equals jinja2's render.
- A scripted engine yields the same ``LLMEngineOutput`` dicts under the
  JAX ``Backend`` + ``OpenAIPreprocessor`` and under the port's: the
  chunk lists, and the aggregated non-streamed bodies, are equal once
  ``id`` and ``created`` are removed. Finish reasons ``length``, ``eos``,
  a stop string and ``cancelled``; logprobs with top alternatives.
"""

import asyncio
import copy

import pytest
import torch
from conftest import async_test

from dynamo_tpu.llm import backend as jbackend
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm import protocols as jproto
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.llm import backend as tbackend
from dynamo_tpu_torch.llm import chat_template
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm import protocols as tproto
from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.engine import AsyncEngine

torch.set_num_threads(1)

MODEL = "tiny-test"
MSGS = [{"role": "system", "content": "you are a test"},
        {"role": "user", "content": "hello world"}]


def chat(**kw):
    return {"model": MODEL, "messages": MSGS, **kw}


def completion(**kw):
    return {"model": MODEL, "prompt": "the quick brown fox", **kw}


CHAT_BODIES = [
    chat(),
    chat(stop="fox", max_tokens=7),
    chat(stop=["a", "bc"], max_completion_tokens=9, max_tokens=3),
    chat(logprobs=True, top_logprobs=3, temperature=0.7, top_p=0.9),
    chat(logprobs=True),
    chat(logprobs=False, top_logprobs=2),
    chat(frequency_penalty=0.5, presence_penalty=-1.0, seed=7, n=1),
    chat(min_tokens=4, ignore_eos=True, top_k=5),
    chat(nvext={"ignore_eos": True, "top_k": 3, "min_tokens": 2, "seed": 11,
                "frequency_penalty": 0.25, "presence_penalty": 0.5}),
    chat(ignore_eos=False, nvext={"ignore_eos": True, "seed": 3}, seed=4),
    chat(messages=[{"role": "user", "content": [
        {"type": "text", "text": "part one "},
        {"type": "input_audio", "input_audio": {}},
        {"type": "text", "text": "part two"}]},
        {"role": "assistant", "content": None},
        {"role": "user", "content": "ok", "name": "bob"}]),
    chat(temperature=1, max_tokens="5", stream="true", extra_key={"x": 1}),
]
COMPLETION_BODIES = [
    completion(),
    completion(prompt=["one element list"], max_tokens=None),
    completion(prompt=[5, 6, 7, 300], max_tokens=4, stop="x"),
    completion(logprobs=2, echo=False, seed=9),
    completion(frequency_penalty=0.5, presence_penalty=0.5, top_k=4,
               top_logprobs=1),
    completion(nvext={"ignore_eos": True, "min_tokens": 3, "seed": 5},
               temperature=0.2, top_p=0.5, stop=["a", "b"]),
    completion(max_completion_tokens=6, ignore_eos=True, min_tokens=1),
]


@pytest.fixture(scope="module")
def pre():
    card_j = jcard.ModelDeploymentCard(
        name=MODEL, chat_template=jcard.DEFAULT_CHAT_TEMPLATE,
        context_length=512)
    card_t = tcard.ModelDeploymentCard(
        name=MODEL, chat_template=tcard.DEFAULT_CHAT_TEMPLATE,
        context_length=512)
    return (jpre.OpenAIPreprocessor(card_j, j_test_tokenizer()),
            tpre.OpenAIPreprocessor(card_t, make_test_tokenizer()))


@pytest.mark.parametrize("i", range(len(CHAT_BODIES)))
def test_chat_wire_dicts_match(pre, i):
    jp, tp = pre
    body = CHAT_BODIES[i]
    want = jp.preprocess_chat(
        jproto.ChatCompletionRequest.model_validate(copy.deepcopy(body)))
    got = tp.preprocess_chat(
        tproto.ChatCompletionRequest.model_validate(copy.deepcopy(body)))
    assert got.to_wire() == want.to_wire()


@pytest.mark.parametrize("i", range(len(COMPLETION_BODIES)))
def test_completion_wire_dicts_match(pre, i):
    jp, tp = pre
    body = COMPLETION_BODIES[i]
    want = jp.preprocess_completion(
        jproto.CompletionRequest.model_validate(copy.deepcopy(body)))
    got = tp.preprocess_completion(
        tproto.CompletionRequest.model_validate(copy.deepcopy(body)))
    assert got.to_wire() == want.to_wire()


def test_refusals(pre):
    _, tp = pre
    batch = tproto.CompletionRequest.model_validate(
        completion(prompt=["a", "b"]))
    with pytest.raises(ValueError, match="batch prompts"):
        tp.preprocess_completion(batch)
    image = tproto.ChatCompletionRequest.model_validate(chat(messages=[
        {"role": "user", "content": [{"type": "image_url",
                                      "image_url": {"url": "data:,"}}]}]))
    with pytest.raises(ValueError, match="image input"):
        tp.preprocess_chat(image)
    with pytest.raises(ValueError, match="only the default chat template"):
        tpre.OpenAIPreprocessor(
            tcard.ModelDeploymentCard(name="m", chat_template="{{ x }}"),
            make_test_tokenizer())
    with pytest.raises(ValueError, match="tool-call parser"):
        tpre.ChatDeltaGenerator(image, 1, tool_call_parser="hermes")
    for bad in ({"model": MODEL}, chat(messages="x"), chat(max_tokens=1.5),
                chat(stream=2), chat(stop=[1]), chat(n=None),
                {"messages": MSGS}, chat(messages=[{"content": "x"}])):
        with pytest.raises(tproto.RequestValidationError):
            tproto.ChatCompletionRequest.model_validate(bad)
        with pytest.raises(Exception):
            jproto.ChatCompletionRequest.model_validate(bad)


def test_model_card_wire_matches():
    for kw in ({}, {"model_type": "completions", "context_length": 4096,
                    "runtime_config": {"total_kv_blocks": 7,
                                       "extra": {"hidden_size": 8}}}):
        rc_j = jcard.ModelRuntimeConfig(**kw.get("runtime_config", {}))
        rc_t = tcard.ModelRuntimeConfig(**kw.get("runtime_config", {}))
        rest = {k: v for k, v in kw.items() if k != "runtime_config"}
        card_j = jcard.ModelDeploymentCard(name="a/b", runtime_config=rc_j,
                                           **rest)
        card_t = tcard.ModelDeploymentCard(name="a/b", runtime_config=rc_t,
                                           **rest)
        assert card_t.to_wire() == card_j.to_wire()
        assert tcard.ModelDeploymentCard.from_wire(card_j.to_wire()) == \
            card_t
        entry = dict(model_name="a/b", namespace="n", component="c",
                     endpoint="e", model_type="chat")
        e_j = jcard.ModelEntry(card=card_j, **entry)
        e_t = tcard.ModelEntry(card=card_t, **entry)
        assert e_t.to_wire() == e_j.to_wire()
        assert tcard.ModelEntry.from_wire(e_j.to_wire()) == e_t
    assert tcard.model_slug("org/name") == jcard.model_slug("org/name")


@pytest.mark.parametrize("messages", [
    MSGS,
    [],
    [{"role": "user", "content": "{{ not a template }} {% raw %}\n\n"}],
    [{"role": "assistant", "content": ""},
     {"role": "tool", "content": "日本語 😀 <|im_end|> tail\r\n"}],
])
def test_chat_template_matches_jinja2(pre, messages):
    import jinja2
    template = jinja2.Environment().from_string(jcard.DEFAULT_CHAT_TEMPLATE)
    for gen in (True, False):
        want = template.render(messages=messages, add_generation_prompt=gen)
        assert chat_template.render(messages, gen) == want
    jp, tp = pre
    body = chat(messages=messages or [{"role": "user", "content": ""}])
    assert tp.apply_chat_template(
        tproto.ChatCompletionRequest.model_validate(body)) == \
        jp.apply_chat_template(
            jproto.ChatCompletionRequest.model_validate(body))


# -- the stream ---------------------------------------------------------------

class ScriptedEngine(AsyncEngine):
    """Yields a fixed list of engine output dicts; records each request's
    wire dict and context. ``hold_after``: after that many items, wait
    until the context is stopped (then end the stream)."""

    def __init__(self, script, hold_after: int | None = None):
        self.script = script
        self.hold_after = hold_after
        self.seen = []

    async def generate(self, request, context):
        wire = request if isinstance(request, dict) else request.to_wire()
        self.seen.append((wire, context))
        for i, item in enumerate(self.script):
            if i == self.hold_after:
                while not context.is_stopped:
                    await asyncio.sleep(0.01)
                return
            await asyncio.sleep(0)
            yield copy.deepcopy(item)


def _script(finish: str, logprobs: bool = False) -> list[dict]:
    tok = make_test_tokenizer()
    # ASCII words, an id outside the vocab, a character split over byte
    # tokens, and a stop-string candidate ("brown f") across two items.
    ids = (tok.encode("hello world the quick brown")
           + [tok.vocab_size + 40] + tok.encode(" fox 日本 jumps"))
    items, step = [], 3
    for k in range(0, len(ids), step):
        item = {"token_ids": ids[k:k + step]}
        if logprobs:
            item["log_probs"] = [-0.5 - 0.1 * j for j in range(len(
                item["token_ids"]))]
            item["top_log_probs"] = [
                [{"token_id": t, "logprob": -0.5},
                 {"token_id": (t * 7 + 3) % (tok.vocab_size + 20),
                  "logprob": -1.25}] for t in item["token_ids"]]
        items.append(item)
    items[-1]["finish_reason"] = finish
    if finish == "cancelled":
        items.append({"token_ids": [], "finish_reason": "cancelled"})
        items[-2].pop("finish_reason")
    return items


STREAM_CASES = [
    ("length", False, {}),
    ("eos", False, {}),
    ("length", False, {"stop": ["brown f"]}),
    ("length", False, {"stop": "zz"}),
    ("cancelled", False, {}),
    ("length", True, {"logprobs": True, "top_logprobs": 2}),
    ("eos", True, {"logprobs": True, "top_logprobs": 2,
                   "stop": ["jum"]}),
]


def strip_ids(chunks):
    return [{k: v for k, v in c.items() if k not in ("id", "created")}
            for c in chunks]


def pipelines(engine):
    """(JAX, port) preprocessors over the same scripted engine."""
    card_j = jcard.ModelDeploymentCard(name=MODEL, context_length=512)
    card_t = tcard.ModelDeploymentCard(name=MODEL, context_length=512)
    return (jpre.OpenAIPreprocessor(
                card_j, j_test_tokenizer(),
                jbackend.Backend(j_test_tokenizer(), engine)),
            tpre.OpenAIPreprocessor(
                card_t, make_test_tokenizer(),
                tbackend.Backend(make_test_tokenizer(), engine)))


async def _collect(gen):
    return [c async for c in gen]


@pytest.mark.parametrize("case", range(len(STREAM_CASES)))
@async_test
async def test_streams_and_aggregates_match(case):
    finish, logprobs, extra = STREAM_CASES[case]
    engine = ScriptedEngine(_script(finish, logprobs))
    jp, tp = pipelines(engine)
    body = chat(stream=True, stream_options={"include_usage": True}, **extra)
    j_chunks = await _collect(jp.generate(
        jproto.ChatCompletionRequest.model_validate(body), JContext()))
    t_ctx = TContext()
    t_chunks = await _collect(tp.generate(
        tproto.ChatCompletionRequest.model_validate(body), t_ctx))
    assert strip_ids(t_chunks) == strip_ids(j_chunks)
    assert t_chunks[-1]["usage"]["completion_tokens"] > 0
    if "stop" in extra and extra["stop"] != "zz":
        assert t_ctx.is_stopped
        assert t_chunks[-2]["choices"][0]["finish_reason"] == "stop"

    async def replay(chunks):
        for c in chunks:
            yield c
    j_full = await jpre.aggregate_chat_stream(replay(j_chunks), 0)
    t_full = await tpre.aggregate_chat_stream(replay(t_chunks), 0)
    assert strip_ids([t_full]) == strip_ids([j_full])

    cbody = completion(stream=True, stream_options={"include_usage": True},
                       **({"logprobs": 2} if logprobs else {}),
                       **{k: v for k, v in extra.items() if k == "stop"})
    j_chunks = await _collect(jp.generate_completion(
        jproto.CompletionRequest.model_validate(cbody), JContext()))
    t_chunks = await _collect(tp.generate_completion(
        tproto.CompletionRequest.model_validate(cbody), TContext()))
    assert strip_ids(t_chunks) == strip_ids(j_chunks)
    wires = [w for w, _ in engine.seen]
    assert wires[1] == wires[0] and wires[3] == wires[2]
