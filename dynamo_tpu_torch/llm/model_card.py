"""Model deployment cards and registration (copy of
``dynamo_tpu.llm.model_card``).

The card carries what a front needs to serve a model: the tokenizer
artifact (shipped through the coordinator's object store), chat template,
context length, kv block size, migration limit and runtime config; the
entry maps the model name to the endpoint that serves it. The keys are
the JAX package's: the entry lives at ``models/{slug}/{instance_id:x}`` on
the worker's primary lease, and the tokenizer blob at
``tokenizers/{slug}-{sha256[:12]}``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

from dynamo_tpu_torch.llm.tokenizer import Tokenizer

MODEL_ROOT = "models/"

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


def model_key(model_name: str, instance_id: int) -> str:
    return f"{MODEL_ROOT}{model_slug(model_name)}/{instance_id:x}"


async def register_llm(
    runtime,
    endpoint,
    model_name: str,
    tokenizer: Tokenizer,
    context_length: int = 8192,
    kv_cache_block_size: int = 16,
    migration_limit: int = 0,
    runtime_config: ModelRuntimeConfig | None = None,
) -> ModelEntry:
    """Register a served model: ship the tokenizer to the object store and
    put the ModelEntry under models/ on the worker's primary lease, again
    whenever the lease is re-granted."""
    client = runtime.require_coordinator()
    blob = tokenizer.to_bytes()
    tok_key = (f"tokenizers/{model_slug(model_name)}-"
               f"{hashlib.sha256(blob).hexdigest()[:12]}")
    await client.object_put(tok_key, blob)
    card = ModelDeploymentCard(
        name=model_name, tokenizer_key=tok_key,
        context_length=context_length,
        kv_cache_block_size=kv_cache_block_size,
        migration_limit=migration_limit,
        runtime_config=runtime_config or ModelRuntimeConfig())
    entry = ModelEntry(model_name=model_name,
                       namespace=endpoint.component.namespace,
                       component=endpoint.component.name,
                       endpoint=endpoint.name, model_type=card.model_type,
                       card=card)
    # Keyed per instance so N workers of one model coexist; the front
    # dedups by model name.
    key = model_key(model_name, runtime.instance_id)
    await client.kv_put(key, entry.to_wire(), use_primary_lease=True)
    # The card rides the primary lease: if the lease expires (the process
    # stalled past the TTL) the coordinator deletes it, so put it again on
    # re-grant, unless deregister_llm retired it. A re-grant after a
    # coordinator restart also finds the object store empty, so the
    # tokenizer goes back first (the reference re-puts only the card).
    runtime.model_cards.add(key)

    async def _reput(_new_lease_id: int) -> None:
        if key in runtime.model_cards:
            await client.object_put(tok_key, blob)
            await client.kv_put(key, entry.to_wire(), use_primary_lease=True)

    client.on_lease_recreated(_reput)
    return entry


async def register_adapter(
    runtime,
    endpoint,
    adapter_name: str,
    base_name: str,
    tokenizer: Tokenizer,
    runtime_config: ModelRuntimeConfig | None = None,
    **kwargs,
) -> ModelEntry:
    """Register a LoRA adapter as a served model name: a whole model card
    under ``models/{adapter-slug}`` pointing at the base model's worker
    endpoint, whose ``runtime_config.extra`` carries the binding
    ``{"lora_base": base_name, "adapter": adapter_name}`` (the reference's
    keys, so either package's front resolves either package's adapter
    cards). The front resolves the OpenAI ``model`` field to this card
    like any other; its preprocessor then puts ``adapter=<name>`` on the
    request, which the worker maps to a LoRA slot (``engine/lora.py``).
    ``kwargs`` go to ``register_llm``."""
    rc = runtime_config or ModelRuntimeConfig()
    rc.extra = dict(rc.extra or {})
    rc.extra.update({"lora_base": base_name, "adapter": adapter_name})
    return await register_llm(runtime, endpoint, adapter_name, tokenizer,
                              runtime_config=rc, **kwargs)


async def deregister_llm(runtime, model_name: str) -> None:
    """Remove this worker's model-card registration."""
    key = model_key(model_name, runtime.instance_id)
    runtime.model_cards.discard(key)
    try:
        await runtime.require_coordinator().kv_delete(key)
    except (ConnectionError, OSError, RuntimeError):
        # Coordinator down: the key rides our lease and the replay guard is
        # cleared, so it cannot come back.
        pass


async def fetch_tokenizer(client, card: ModelDeploymentCard) -> Tokenizer:
    if card.tokenizer_key is None:
        raise ValueError(f"model card {card.name} has no tokenizer artifact")
    blob = await client.object_get(card.tokenizer_key)
    if blob is None:
        raise KeyError(f"tokenizer object {card.tokenizer_key} missing")
    return Tokenizer.from_bytes(blob)
