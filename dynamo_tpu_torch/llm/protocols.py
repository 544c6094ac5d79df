"""Internal request/response types (dataclass copies of the pydantic models
in ``dynamo_tpu.llm.protocols``).

PreprocessedRequest and LLMEngineOutput travel between the frontend and
the engine as plain dicts. ``to_wire``/``from_wire`` read and write the
same dicts as the reference: ``None`` fields are left out at every level
and unknown keys are ignored on read.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any


class FinishReason(str, Enum):
    STOP = "stop"            # stop string / stop token matched
    EOS = "eos"              # model emitted EOS
    LENGTH = "length"        # max_tokens reached
    CANCELLED = "cancelled"  # client disconnected / ctx stopped
    ERROR = "error"


def _drop_none(value):
    if isinstance(value, dict):
        return {k: _drop_none(v) for k, v in value.items() if v is not None}
    if isinstance(value, list):
        return [_drop_none(v) for v in value]
    return value


def _known(cls, data: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in data.items() if k in names}


@dataclasses.dataclass
class StopConditions:
    max_tokens: int | None = None
    min_tokens: int | None = None
    stop: list[str] = dataclasses.field(default_factory=list)
    stop_token_ids: list[int] = dataclasses.field(default_factory=list)
    ignore_eos: bool = False


@dataclasses.dataclass
class SamplingOptions:
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    seed: int | None = None
    n: int = 1
    logprobs: int | None = None


@dataclasses.dataclass
class PreprocessedRequest:
    """Tokens-in request: the frontend->worker contract."""

    model: str
    token_ids: list[int]
    stop_conditions: StopConditions = dataclasses.field(
        default_factory=StopConditions)
    sampling_options: SamplingOptions = dataclasses.field(
        default_factory=SamplingOptions)
    eos_token_ids: list[int] = dataclasses.field(default_factory=list)
    annotations: dict[str, Any] = dataclasses.field(default_factory=dict)
    adapter: str | None = None
    disagg_params: dict[str, Any] | None = None
    estimated_prefix_hit_blocks: int = 0
    mm_embeds: list[dict] | None = None

    def to_wire(self) -> dict:
        return _drop_none(dataclasses.asdict(self))

    @classmethod
    def from_wire(cls, data: dict) -> "PreprocessedRequest":
        data = _known(cls, data)
        data["token_ids"] = list(data["token_ids"])
        data["stop_conditions"] = StopConditions(
            **_known(StopConditions, data.get("stop_conditions") or {}))
        data["sampling_options"] = SamplingOptions(
            **_known(SamplingOptions, data.get("sampling_options") or {}))
        return cls(**data)


@dataclasses.dataclass
class LLMEngineOutput:
    """One streamed engine response."""

    token_ids: list[int] = dataclasses.field(default_factory=list)
    text: str | None = None
    finish_reason: FinishReason | None = None
    cum_log_prob: float | None = None
    log_probs: list[float] | None = None
    top_log_probs: list[list[dict[str, Any]]] | None = None
    token_texts: list[str] | None = None
    metrics: dict[str, Any] | None = None
    disagg_params: dict[str, Any] | None = None

    def to_wire(self) -> dict:
        return _drop_none(dataclasses.asdict(self))

    @classmethod
    def from_wire(cls, data: dict) -> "LLMEngineOutput":
        data = _known(cls, data)
        if data.get("finish_reason") is not None:
            data["finish_reason"] = FinishReason(data["finish_reason"])
        return cls(**data)
