"""Request/response types (dataclass copies of the pydantic models in
``dynamo_tpu.llm.protocols``).

PreprocessedRequest and LLMEngineOutput travel between the frontend and
the engine as plain dicts. ``to_wire``/``from_wire`` read and write the
same dicts as the reference: ``None`` fields are left out at every level
and unknown keys are ignored on read.

The OpenAI request bodies (``ChatCompletionRequest``,
``CompletionRequest``) are validated at the HTTP edge by
``model_validate``, with the coercions of pydantic's lax mode for the
types they use; extra keys are kept and read as attributes. A body that
fails raises ``RequestValidationError``, which the front answers with a
400.
"""

from __future__ import annotations

import dataclasses
import math
import time
import uuid
from enum import Enum
from typing import Any


class FinishReason(str, Enum):
    STOP = "stop"            # stop string / stop token matched
    EOS = "eos"              # model emitted EOS
    LENGTH = "length"        # max_tokens reached
    CANCELLED = "cancelled"  # client disconnected / ctx stopped
    ERROR = "error"

    def to_openai(self) -> str:
        return {"eos": "stop", "cancelled": "stop"}.get(self.value, self.value)


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


# ---------------------------------------------------------------------------
# OpenAI API types
# ---------------------------------------------------------------------------

class RequestValidationError(ValueError):
    """An OpenAI request body that does not validate."""


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _fail(path: str, what: str, value) -> RequestValidationError:
    return RequestValidationError(
        f"{path}: input should be {what}, got {value!r}")


def _as_str(value, path: str) -> str:
    if isinstance(value, str):
        return value
    raise _fail(path, "a valid string", value)


def _as_int(value, path: str) -> int:
    if isinstance(value, int):  # bool included, as int(True) == 1
        return int(value)
    if isinstance(value, float) and math.isfinite(value) \
            and value.is_integer():
        return int(value)
    if isinstance(value, str):
        try:
            return int(value.strip())
        except ValueError:
            pass
    raise _fail(path, "a valid integer", value)


def _as_float(value, path: str) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        try:
            return float(value.strip())
        except ValueError:
            pass
    raise _fail(path, "a valid number", value)


def _as_bool(value, path: str) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, int) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
        return value.strip().lower() in _TRUE
    raise _fail(path, "a valid boolean", value)


def _as_dict(value, path: str) -> dict:
    if isinstance(value, dict):
        return value
    raise _fail(path, "a valid dictionary", value)


def _as_list(value, path: str) -> list:
    if isinstance(value, list):
        return value
    raise _fail(path, "a valid list", value)


def _as_stop(value, path: str) -> str | list[str]:
    if isinstance(value, str):
        return value
    return [_as_str(v, f"{path}.{i}")
            for i, v in enumerate(_as_list(value, path))]


def _as_content(value, path: str) -> str | list[dict]:
    if isinstance(value, str):
        return value
    return [_as_dict(v, f"{path}.{i}")
            for i, v in enumerate(_as_list(value, path))]


def _as_prompt(value, path: str) -> str | list[str] | list[int]:
    if isinstance(value, str):
        return value
    items = _as_list(value, path)
    if all(isinstance(v, str) for v in items):
        return list(items)
    return [_as_int(v, f"{path}.{i}") for i, v in enumerate(items)]


def _as_messages(value, path: str) -> list["ChatMessage"]:
    return [ChatMessage.model_validate(_as_dict(v, f"{path}.{i}"),
                                       f"{path}.{i}")
            for i, v in enumerate(_as_list(value, path))]


class _Validated:
    """Base of the OpenAI request dataclasses: ``model_validate(dict)``
    checks required fields and types (``_TYPES``: field -> coercer; a
    ``None`` value passes where the field's type admits it) and keeps extra
    keys in ``extra``, readable as attributes."""

    _TYPES: dict = {}
    _NVEXT: tuple[str, ...] = ()

    @classmethod
    def model_validate(cls, data, path: str | None = None):
        path = path or cls.__name__
        data = dict(_as_dict(data, path))
        nvext = data.get("nvext")
        if isinstance(nvext, dict):
            # The reference's nvext block: the same knobs nested under
            # "nvext"; flat fields win, nvext values get validated.
            for key in cls._NVEXT:
                if data.get(key) is None and key in nvext:
                    data[key] = nvext[key]
        values, extra = {}, {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in data.items():
            if key not in fields or key == "extra":
                extra[key] = value
                continue
            if value is None and "None" in str(fields[key].type):
                values[key] = None
            else:
                values[key] = cls._TYPES[key](value, f"{path}.{key}")
        missing = [n for n, f in fields.items()
                   if n not in values and n != "extra"
                   and f.default is dataclasses.MISSING
                   and f.default_factory is dataclasses.MISSING]
        if missing:
            raise RequestValidationError(
                f"{path}: field required: {', '.join(missing)}")
        return cls(**values, extra=extra)

    def __getattr__(self, name: str):
        extra = self.__dict__.get("extra") or {}
        if name in extra:
            return extra[name]
        raise AttributeError(name)


@dataclasses.dataclass
class ChatMessage(_Validated):
    role: str
    content: str | list[dict[str, Any]] | None = None
    name: str | None = None
    tool_calls: list[dict[str, Any]] | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    _TYPES = {"role": _as_str, "content": _as_content, "name": _as_str,
              "tool_calls": lambda v, p: [
                  _as_dict(x, f"{p}.{i}") for i, x in enumerate(_as_list(v, p))]}

    def text_content(self) -> str:
        if self.content is None:
            return ""
        if isinstance(self.content, str):
            return self.content
        return "".join(p.get("text", "") for p in self.content
                       if p.get("type") == "text")


@dataclasses.dataclass
class ChatCompletionRequest(_Validated):
    model: str
    messages: list[ChatMessage]
    max_tokens: int | None = None
    max_completion_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None  # extension (nvext-style)
    n: int = 1
    stream: bool = False
    stream_options: dict[str, Any] | None = None
    stop: str | list[str] | None = None
    presence_penalty: float | None = None
    frequency_penalty: float | None = None
    seed: int | None = None
    logprobs: bool | None = None
    top_logprobs: int | None = None
    ignore_eos: bool | None = None  # extension
    min_tokens: int | None = None  # extension
    nvext: dict[str, Any] | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    _TYPES = {"model": _as_str, "messages": _as_messages,
              "max_tokens": _as_int, "max_completion_tokens": _as_int,
              "temperature": _as_float, "top_p": _as_float,
              "top_k": _as_int, "n": _as_int, "stream": _as_bool,
              "stream_options": _as_dict, "stop": _as_stop,
              "presence_penalty": _as_float, "frequency_penalty": _as_float,
              "seed": _as_int, "logprobs": _as_bool, "top_logprobs": _as_int,
              "ignore_eos": _as_bool, "min_tokens": _as_int,
              "nvext": _as_dict}
    _NVEXT = ("ignore_eos", "top_k", "min_tokens", "seed",
              "frequency_penalty", "presence_penalty")

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


@dataclasses.dataclass
class CompletionRequest(_Validated):
    model: str
    prompt: str | list[str] | list[int]
    max_tokens: int | None = 16
    temperature: float | None = None
    top_p: float | None = None
    n: int = 1
    stream: bool = False
    stream_options: dict[str, Any] | None = None
    stop: str | list[str] | None = None
    seed: int | None = None
    echo: bool = False
    ignore_eos: bool | None = None
    nvext: dict[str, Any] | None = None
    min_tokens: int | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    _TYPES = {"model": _as_str, "prompt": _as_prompt, "max_tokens": _as_int,
              "temperature": _as_float, "top_p": _as_float, "n": _as_int,
              "stream": _as_bool, "stream_options": _as_dict,
              "stop": _as_stop, "seed": _as_int, "echo": _as_bool,
              "ignore_eos": _as_bool, "nvext": _as_dict,
              "min_tokens": _as_int}
    _NVEXT = ("ignore_eos", "seed", "min_tokens")

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


def completion_id() -> str:
    return "cmpl-" + uuid.uuid4().hex[:24]


def chat_completion_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:24]


def now_unix() -> int:
    return int(time.time())


def usage_block(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }
