"""Model source resolution: preset | local directory | cached HF hub id
(counterpart of ``dynamo_tpu.engine.hub`` with downloads off).

A model argument resolves, in order, to a built-in preset, a local
checkpoint directory (one that holds ``config.json``), or a Hugging Face
hub id already in the local HF cache. The cache is read on the standard
library, as ``huggingface_hub.snapshot_download(local_files_only=True)``
reads it: ``$HF_HUB_CACHE`` (else ``$HF_HOME/hub``, else
``~/.cache/huggingface/hub``), then ``models--ORG--NAME/refs/<revision>``
(``main`` by default; a 40-hex revision is the commit itself), then
``snapshots/<commit>/``.

Nothing is ever downloaded: the port has no ``huggingface_hub`` and the
GPU machine no network. A hub id that is not in the cache raises
``FileNotFoundError`` with the reference's message for downloads turned
off; pre-populate the cache, or pass a local checkpoint directory.
"""

from __future__ import annotations

import os
import re

from dynamo_tpu_torch.engine.config import PRESETS, ModelSpec
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("hub")

_CHECKPOINT_FILES = ("config.json",)
# huggingface_hub's rules for a repo id ("name" or "namespace/name").
_REPO_ID = re.compile(r"^(\b[\w\-.]+\b/)?\b[\w\-.]{1,96}\b$")
_COMMIT = re.compile(r"^[0-9a-f]{40}$")


def looks_like_checkpoint_dir(path: str) -> bool:
    return os.path.isdir(path) and all(
        os.path.exists(os.path.join(path, f)) for f in _CHECKPOINT_FILES)


def hub_cache_dir() -> str:
    """The HF hub cache the environment names."""
    cache = os.environ.get("HF_HUB_CACHE") or os.environ.get(
        "HUGGINGFACE_HUB_CACHE")
    if cache:
        return os.path.expanduser(cache)
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.join("~", ".cache")),
        "huggingface")
    return os.path.join(os.path.expanduser(home), "hub")


def _invalid_repo_id(model: str) -> str | None:
    """Why ``model`` is not a hub id, or None when it is one."""
    if model.count("/") > 1:
        return "Repo id must be in the form 'repo_name' or " \
               f"'namespace/repo_name': '{model}'."
    if not _REPO_ID.match(model):
        return "Repo id must use alphanumeric chars, '-', '_' or '.'. The " \
               "name cannot start or end with '-' or '.' and the maximum " \
               f"length is 96: '{model}'."
    if "--" in model or ".." in model:
        return f"Cannot have -- or .. in repo_id: '{model}'."
    if model.endswith(".git"):
        return f"Repo_id cannot end by '.git': '{model}'."
    return None


def cached_snapshot(model: str, revision: str | None = None) -> str | None:
    """The snapshot directory of hub id ``model`` at ``revision`` in the
    local HF cache, or None when the cache does not hold it."""
    revision = revision or "main"
    storage = os.path.join(hub_cache_dir(),
                           "models--" + model.replace("/", "--"))
    commit = revision if _COMMIT.match(revision) else None
    ref = os.path.join(storage, "refs", revision)
    if commit is None and os.path.exists(ref):
        with open(ref) as fh:
            commit = fh.read()
    if commit is None:
        return None
    snapshot = os.path.join(storage, "snapshots", commit)
    return snapshot if os.path.exists(snapshot) else None


def resolve_model(model: str, revision: str | None = None
                  ) -> tuple[ModelSpec, str | None]:
    """Resolve ``model`` to (spec, checkpoint_dir). checkpoint_dir is None
    for presets (random-weight serving)."""
    if model in PRESETS:
        return PRESETS[model], None
    if looks_like_checkpoint_dir(model):
        return ModelSpec.from_hf_config(model), model
    if os.path.sep in model and not model.count("/") == 1:
        raise FileNotFoundError(
            f"{model!r} is not a preset ({sorted(PRESETS)}), not a local "
            f"checkpoint directory, and not a hub id")
    why = _invalid_repo_id(model)
    if why:
        raise FileNotFoundError(
            f"{model!r} is not a preset ({sorted(PRESETS)}), not a local "
            f"checkpoint directory, and not a valid hub id ({why})")
    path = cached_snapshot(model, revision)
    if path is None:
        raise FileNotFoundError(
            f"{model!r} is not in the local HF cache and downloads are "
            f"disabled; pre-populate the cache (HF_HOME="
            f"{os.environ.get('HF_HOME', '~/.cache/huggingface')})")
    log.info("resolved %s from local HF cache: %s", model, path)
    return ModelSpec.from_hf_config(path), path
