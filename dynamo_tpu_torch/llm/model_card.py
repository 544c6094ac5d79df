"""Model deployment cards (the local part of ``dynamo_tpu.llm.model_card``).

The card carries what a front needs to serve a model: chat template,
context length, kv block size, migration limit, runtime config; the entry
maps the model name to the endpoint that serves it. Registration with a
coordinator and fetching a tokenizer from its object store wait for the
worker-main slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# Default chat template used when a model ships none: a minimal ChatML-style
# template. ``llm/chat_template.py`` renders exactly this string.
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|im_start|>{{ message['role'] }}\n{{ message['content'] }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


@dataclasses.dataclass
class ModelRuntimeConfig:
    """Engine capacity facts published at registration."""

    total_kv_blocks: int | None = None
    max_num_seqs: int | None = None
    max_num_batched_tokens: int | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, data: dict | None) -> "ModelRuntimeConfig":
        data = data or {}
        return cls(**{f.name: data.get(f.name) if f.name != "extra"
                      else data.get("extra", {}) for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class ModelDeploymentCard:
    name: str
    model_type: str = "chat"  # chat | completions | embedding
    tokenizer_key: str | None = None  # object-store key for tokenizer.json bytes
    chat_template: str | None = None
    context_length: int = 8192
    kv_cache_block_size: int = 16
    migration_limit: int = 0
    # Backward-edge parsers: not ported; a card that names one is refused
    # by the preprocessor.
    tool_call_parser: str | None = None
    reasoning_parser: str | None = None
    runtime_config: ModelRuntimeConfig = dataclasses.field(
        default_factory=ModelRuntimeConfig)

    def to_wire(self) -> dict:
        d = dataclasses.asdict(self)
        d["runtime_config"] = self.runtime_config.to_wire()
        return d

    @classmethod
    def from_wire(cls, data: dict) -> "ModelDeploymentCard":
        data = dict(data)
        data["runtime_config"] = ModelRuntimeConfig.from_wire(
            data.get("runtime_config"))
        return cls(**{f.name: data[f.name] for f in dataclasses.fields(cls)
                      if f.name in data})


@dataclasses.dataclass
class ModelEntry:
    """models/{slug} KV entry."""

    model_name: str
    namespace: str
    component: str
    endpoint: str
    model_type: str
    card: ModelDeploymentCard

    def to_wire(self) -> dict:
        d = dataclasses.asdict(self)
        d["card"] = self.card.to_wire()
        return d

    @classmethod
    def from_wire(cls, data: dict) -> "ModelEntry":
        return cls(model_name=data["model_name"], namespace=data["namespace"],
                   component=data["component"], endpoint=data["endpoint"],
                   model_type=data.get("model_type", "chat"),
                   card=ModelDeploymentCard.from_wire(data["card"]))


def model_slug(name: str) -> str:
    return name.replace("/", "--")
