"""The default chat template rendered without jinja2.

``render`` gives what jinja2 renders from ``DEFAULT_CHAT_TEMPLATE`` (the
messages loop, then ``add_generation_prompt``), the counterpart of the
reference preprocessor's jinja2 render. A card with any other template is
refused: only the default template is rendered.
"""

from __future__ import annotations

from dynamo_tpu_torch.llm.model_card import DEFAULT_CHAT_TEMPLATE


def check_template(template: str | None) -> None:
    """Raise ``ValueError`` unless ``template`` is the default (or None,
    which means the default)."""
    if template is not None and template != DEFAULT_CHAT_TEMPLATE:
        raise ValueError(
            "only the default chat template (DEFAULT_CHAT_TEMPLATE) is "
            "rendered; this model card carries another chat_template")


def render(messages: list[dict], add_generation_prompt: bool) -> str:
    """``messages``: dicts with str ``role`` and ``content``."""
    out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
           for m in messages]
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)
