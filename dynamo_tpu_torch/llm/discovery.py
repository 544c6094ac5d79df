"""Served models of the one-process launcher (the ``ServedModel`` and
``ModelManager`` of ``dynamo_tpu.llm.discovery``; the watcher of a
coordinator's models/ prefix and the router engine wait for the worker-main
slice of the port)."""

from __future__ import annotations

from dynamo_tpu_torch.llm.model_card import ModelEntry
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor


class ServedModel:
    """One servable model: its entry and its tokenizer-bound pipeline."""

    def __init__(self, entry: ModelEntry, preprocessor: OpenAIPreprocessor):
        self.entry = entry
        self.preprocessor = preprocessor

    @property
    def name(self) -> str:
        return self.entry.model_name


class ModelManager:
    """Holds the set of currently-servable models."""

    def __init__(self):
        self.models: dict[str, ServedModel] = {}

    def get(self, name: str) -> ServedModel | None:
        return self.models.get(name)

    def list_models(self) -> list[dict]:
        return [{"id": m.name, "object": "model", "created": 0,
                 "owned_by": "dynamo-tpu"} for m in self.models.values()]
