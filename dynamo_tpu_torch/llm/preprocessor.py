"""OpenAI preprocessor: requests -> tokens, engine outputs -> OpenAI chunks
(copy of ``dynamo_tpu.llm.preprocessor``).

The forward direction renders the default chat template
(``llm/chat_template.py``, no jinja2), tokenizes, and applies sampling and
stop defaulting into a PreprocessedRequest; the backward direction turns
LLMEngineOutput streams into OpenAI chat.completion.chunk /
text_completion deltas with usage and finish reasons. When the card
names parsers (``llm/parsers.py``), think-tags go out as
``reasoning_content`` deltas and tool-call payloads are held out of the
content and emitted as ``tool_calls`` at finish. Image parts and the
vision encoder are not ported: a request with an image raises
``ValueError`` (a 400 at the front).
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm import chat_template
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.parsers import (StreamingReasoningParser,
                                          StreamingToolCallParser)
from dynamo_tpu_torch.llm.protocols import (
    ChatCompletionRequest,
    CompletionRequest,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
    chat_completion_id,
    completion_id,
    now_unix,
    usage_block,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Operator


class OpenAIPreprocessor(Operator):
    def __init__(self, card: ModelDeploymentCard, tokenizer: Tokenizer,
                 inner: AsyncEngine | None = None):
        super().__init__(inner)
        chat_template.check_template(card.chat_template)
        self.card = card
        self.tokenizer = tokenizer
        self.eos_ids = tokenizer.eos_token_ids()

    # -- forward: OpenAI -> PreprocessedRequest ------------------------------
    def apply_chat_template(self, request: ChatCompletionRequest) -> str:
        messages = [{"role": m.role, "content": m.text_content()}
                    for m in request.messages]
        return chat_template.render(messages, add_generation_prompt=True)

    def preprocess_chat(self, request: ChatCompletionRequest
                        ) -> PreprocessedRequest:
        if any(part.get("type") == "image_url"
               for m in request.messages if isinstance(m.content, list)
               for part in m.content):
            raise ValueError("image input is not supported by the port "
                             "(no vision encoder yet)")
        prompt = self.apply_chat_template(request)
        token_ids = self.tokenizer.encode(prompt)
        return self._build(request.model, token_ids, request, prompt)

    def preprocess_completion(self, request: CompletionRequest
                              ) -> PreprocessedRequest:
        prompt_in = request.prompt
        if isinstance(prompt_in, list) and prompt_in and isinstance(
                prompt_in[0], str):
            if len(prompt_in) > 1:
                # Batch prompts need one choice per element; reject loudly
                # rather than silently concatenating.
                raise ValueError(
                    "batch prompts (list of strings) are not supported; send "
                    "one request per prompt")
            prompt_in = prompt_in[0]
        if isinstance(prompt_in, list):
            token_ids = list(prompt_in)
            prompt = None
        else:
            prompt = prompt_in
            token_ids = self.tokenizer.encode(prompt)
        return self._build(request.model, token_ids, request, prompt)

    def _build(self, model: str, token_ids: list[int], request,
               formatted_prompt: str | None) -> PreprocessedRequest:
        max_tokens = (getattr(request, "max_completion_tokens", None)
                      or request.max_tokens)
        if max_tokens is None:
            # Default to the remaining context.
            max_tokens = max(1, self.card.context_length - len(token_ids))
        stop = StopConditions(
            max_tokens=max_tokens,
            min_tokens=request.min_tokens,
            stop=request.stop_list(),
            ignore_eos=bool(request.ignore_eos),
        )
        # logprobs: chat uses bool logprobs + int top_logprobs; the legacy
        # completion API uses an int. Normalize to "None = off, k = chosen
        # token + k alternatives".
        lp_req = getattr(request, "logprobs", None)
        if isinstance(lp_req, bool):
            logprobs_n = (getattr(request, "top_logprobs", None) or 0) \
                if lp_req else None
        else:
            logprobs_n = lp_req
        sampling = SamplingOptions(
            temperature=request.temperature,
            top_p=request.top_p,
            top_k=getattr(request, "top_k", None),
            frequency_penalty=getattr(request, "frequency_penalty", None),
            presence_penalty=getattr(request, "presence_penalty", None),
            seed=request.seed,
            n=request.n,
            logprobs=logprobs_n,
        )
        annotations: dict[str, Any] = {}
        if formatted_prompt is not None:
            annotations["formatted_prompt"] = formatted_prompt
        # An adapter card (model_card.register_adapter) names the base
        # model it rides on: the request carries the adapter, which the
        # worker maps to a resident LoRA slot.
        extra = self.card.runtime_config.extra or {}
        adapter = extra.get("adapter") if extra.get("lora_base") else None
        return PreprocessedRequest(
            model=model, token_ids=token_ids, stop_conditions=stop,
            sampling_options=sampling, eos_token_ids=self.eos_ids,
            annotations=annotations, adapter=adapter)

    # -- operator interface ---------------------------------------------------
    async def generate(self, request: ChatCompletionRequest,
                       context: Context) -> AsyncIterator[dict]:
        """Full chat pipeline edge: forward preprocess, stream deltas back."""
        assert self.inner is not None, "preprocessor not linked to an engine"
        pre = self.preprocess_chat(request)
        delta_gen = ChatDeltaGenerator(
            request, prompt_tokens=len(pre.token_ids),
            tool_call_parser=self.card.tool_call_parser,
            reasoning_parser=self.card.reasoning_parser)
        async for out in self.inner.generate(pre, context):
            engine_out = (out if isinstance(out, LLMEngineOutput)
                          else LLMEngineOutput.from_wire(out))
            for chunk in delta_gen.step(engine_out):
                yield chunk

    async def generate_completion(self, request: CompletionRequest,
                                  context: Context) -> AsyncIterator[dict]:
        """Text-completion pipeline edge (mirrors the chat edge so the HTTP
        layer never reaches into pipeline internals)."""
        assert self.inner is not None, "preprocessor not linked to an engine"
        pre = self.preprocess_completion(request)
        delta_gen = CompletionDeltaGenerator(request,
                                             prompt_tokens=len(pre.token_ids))
        async for out in self.inner.generate(pre, context):
            engine_out = (out if isinstance(out, LLMEngineOutput)
                          else LLMEngineOutput.from_wire(out))
            for chunk in delta_gen.step(engine_out):
                yield chunk


class ChatDeltaGenerator:
    """LLMEngineOutput stream -> OpenAI chat.completion.chunk dicts. When
    the card names parsers, think-tags split into reasoning_content deltas
    and tool-call payloads are held out of the content stream and emitted
    as tool_calls at finish (finish_reason becomes "tool_calls")."""

    def __init__(self, request: ChatCompletionRequest, prompt_tokens: int,
                 tool_call_parser: str | None = None,
                 reasoning_parser: str | None = None):
        self.id = chat_completion_id()
        self.model = request.model
        self.created = now_unix()
        self.prompt_tokens = prompt_tokens
        self.completion_tokens = 0
        self.include_usage = bool(
            (request.stream_options or {}).get("include_usage"))
        self._first = True
        self._reasoning = (StreamingReasoningParser(reasoning_parser)
                           if reasoning_parser else None)
        self._tools = (StreamingToolCallParser(tool_call_parser)
                       if tool_call_parser else None)

    def _base(self) -> dict:
        return {"id": self.id, "object": "chat.completion.chunk",
                "created": self.created, "model": self.model}

    def step(self, out: LLMEngineOutput) -> list[dict]:
        chunks: list[dict] = []
        self.completion_tokens += len(out.token_ids)
        delta: dict[str, Any] = {}
        if self._first:
            delta["role"] = "assistant"
            self._first = False
        content = out.text or ""
        reasoning = ""
        if self._reasoning is not None and content:
            content, reasoning = self._reasoning.feed(content)
        if self._tools is not None and content:
            content = self._tools.feed(content)
        finish = out.finish_reason.to_openai() if out.finish_reason else None
        if finish:
            if self._reasoning is not None:
                tail_c, tail_r = self._reasoning.finish()
                if self._tools is not None and tail_c:
                    tail_c = self._tools.feed(tail_c)
                content += tail_c
                reasoning += tail_r
            if self._tools is not None:
                trailing, calls = self._tools.finish()
                content += trailing
                if calls:
                    delta["tool_calls"] = [c.to_openai(i)
                                           for i, c in enumerate(calls)]
                    finish = "tool_calls"
        if content:
            delta["content"] = content
        if reasoning:
            delta["reasoning_content"] = reasoning
        lp_block = None
        if out.log_probs is not None:
            entries = []
            texts = out.token_texts or [""] * len(out.log_probs)
            tops = out.top_log_probs or [[]] * len(out.log_probs)
            for t_text, lp, alts in zip(texts, out.log_probs, tops):
                entries.append({
                    "token": t_text, "logprob": lp, "bytes": None,
                    "top_logprobs": [
                        {"token": a.get("token", ""),
                         "logprob": a["logprob"], "bytes": None}
                        for a in alts]})
            lp_block = {"content": entries}
        if delta or finish or lp_block:
            # lp_block alone still emits: tokens whose text is held back
            # (stop-string prefix, tool-call jail) must not lose their
            # logprobs.
            chunk = self._base()
            chunk["choices"] = [{"index": 0, "delta": delta,
                                 "logprobs": lp_block,
                                 "finish_reason": finish}]
            chunks.append(chunk)
        if finish and self.include_usage:
            usage_chunk = self._base()
            usage_chunk["choices"] = []
            usage_chunk["usage"] = usage_block(self.prompt_tokens,
                                              self.completion_tokens)
            chunks.append(usage_chunk)
        return chunks


class CompletionDeltaGenerator:
    """LLMEngineOutput stream -> OpenAI text_completion chunks."""

    def __init__(self, request: CompletionRequest, prompt_tokens: int):
        self.id = completion_id()
        self.model = request.model
        self.created = now_unix()
        self.prompt_tokens = prompt_tokens
        self.completion_tokens = 0
        self.include_usage = bool(
            (request.stream_options or {}).get("include_usage"))

    def step(self, out: LLMEngineOutput) -> list[dict]:
        self.completion_tokens += len(out.token_ids)
        finish = out.finish_reason.to_openai() if out.finish_reason else None
        chunks = []
        lp_block = None
        if out.log_probs is not None:
            # Legacy completions logprobs shape.
            lp_block = {
                "tokens": out.token_texts or [],
                "token_logprobs": out.log_probs,
                "top_logprobs": [
                    {a.get("token", ""): a["logprob"] for a in alts}
                    for alts in (out.top_log_probs or [])],
                "text_offset": [],
            }
        if out.text or finish or lp_block:
            chunks.append({
                "id": self.id, "object": "text_completion",
                "created": self.created, "model": self.model,
                "choices": [{"index": 0, "text": out.text or "",
                             "finish_reason": finish, "logprobs": lp_block}],
            })
        if finish and self.include_usage:
            chunks.append({
                "id": self.id, "object": "text_completion",
                "created": self.created, "model": self.model, "choices": [],
                "usage": usage_block(self.prompt_tokens, self.completion_tokens),
            })
        return chunks


async def aggregate_chat_stream(chunks: AsyncIterator[dict],
                                prompt_tokens: int) -> dict:
    """Fold a chunk stream into a non-streaming chat.completion response
    (reasoning_content and tool_calls carried as the reference's)."""
    content: list[str] = []
    reasoning: list[str] = []
    tool_calls: list[dict] = []
    lp_entries: list[dict] = []
    role = "assistant"
    finish_reason = None
    cid = None
    model = None
    created = None
    usage = None
    completion_tokens = 0
    async for chunk in chunks:
        cid = chunk.get("id", cid)
        model = chunk.get("model", model)
        created = chunk.get("created", created)
        if chunk.get("usage"):
            usage = chunk["usage"]
        for choice in chunk.get("choices", []):
            delta = choice.get("delta", {})
            if delta.get("content"):
                content.append(delta["content"])
            if delta.get("reasoning_content"):
                reasoning.append(delta["reasoning_content"])
            if delta.get("tool_calls"):
                tool_calls.extend(delta["tool_calls"])
            if delta.get("role"):
                role = delta["role"]
            if choice.get("logprobs"):
                lp_entries.extend(choice["logprobs"].get("content") or [])
            if choice.get("finish_reason"):
                finish_reason = choice["finish_reason"]
    message: dict[str, Any] = {"role": role, "content": "".join(content)}
    if reasoning:
        message["reasoning_content"] = "".join(reasoning)
    if tool_calls:
        message["tool_calls"] = tool_calls
        message["content"] = message["content"] or None
    return {
        "id": cid, "object": "chat.completion", "created": created,
        "model": model,
        "choices": [{"index": 0, "message": message,
                     "logprobs": ({"content": lp_entries}
                                  if lp_entries else None),
                     "finish_reason": finish_reason}],
        "usage": usage or usage_block(prompt_tokens, completion_tokens),
    }
