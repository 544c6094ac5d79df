"""Detokenizing backend operator (copy of ``dynamo_tpu.llm.backend``).

A no-op on the forward (request) edge; on the backward (response) edge it
incrementally detokenizes token_ids into text deltas and enforces stop
strings, cutting the stream and rewriting the finish reason when a stop
string is matched in decoded text.
"""

from __future__ import annotations

from typing import AsyncIterator

from dynamo_tpu_torch.llm.protocols import (FinishReason, LLMEngineOutput,
                                            PreprocessedRequest)
from dynamo_tpu_torch.llm.tokenizer import (DecodeStream, StopSequenceChecker,
                                            Tokenizer)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Operator


class Backend(Operator):
    def __init__(self, tokenizer: Tokenizer, inner: AsyncEngine | None = None):
        super().__init__(inner)
        self.tokenizer = tokenizer

    async def generate(self, request: PreprocessedRequest | dict,
                       context: Context) -> AsyncIterator[LLMEngineOutput]:
        assert self.inner is not None
        req = (request if isinstance(request, PreprocessedRequest)
               else PreprocessedRequest.from_wire(request))
        decoder = DecodeStream(self.tokenizer)
        stops = StopSequenceChecker(req.stop_conditions.stop)
        async for raw in self.inner.generate(request, context):
            out = (raw if isinstance(raw, LLMEngineOutput)
                   else LLMEngineOutput.from_wire(raw))
            pieces: list[str] = []
            for tid in out.token_ids:
                delta = decoder.step(tid)
                if delta is not None:
                    pieces.append(delta)
            text = "".join(pieces)
            if out.log_probs is not None:
                # The OpenAI logprobs block needs per-token strings: decode
                # each id standalone (and the top alternatives' ids).
                out.token_texts = [self.tokenizer.decode([tid])
                                   for tid in out.token_ids]
                for alts in out.top_log_probs or []:
                    for alt in alts:
                        alt["token"] = self.tokenizer.decode(
                            [alt["token_id"]])
            if text:
                emit, matched = stops.append(text)
                if matched:
                    # Stop string hit: truncate, finish, and stop the engine.
                    out.text = emit or None
                    out.finish_reason = FinishReason.STOP
                    yield out
                    context.stop_generating()
                    return
                out.text = emit or None
            else:
                out.text = None
            if out.finish_reason is not None:
                # Stream over without a stop match: release any held-back
                # tail (a partial stop-string prefix) so no text is lost.
                held = stops.flush()
                if held:
                    out.text = (out.text or "") + held
            yield out
            if out.finish_reason is not None:
                return
