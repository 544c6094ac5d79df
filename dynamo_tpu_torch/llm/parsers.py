"""Tool-call and reasoning parsers for the backward (detokenized) edge
(copy of ``dynamo_tpu.llm.parsers``, standard library only).

Config-driven JSON tool-call extraction for the common model formats and
<think>-style reasoning splitting, in batch AND streaming forms. The
streaming parser "jails" output once a start marker (or its prefix at the
buffer tail) appears, so tool-call JSON never leaks into content deltas.

Formats (reference parsers.rs:44-126):
- hermes:        <tool_call>{...}</tool_call>          (one call per block)
- nemotron_deci: <TOOLCALL>[{...}, ...]</TOOLCALL>
- llama3_json:   <|python_tag|>{...} or a bare leading JSON object
- mistral:       [TOOL_CALLS][{...}, ...]
- phi4:          functools[{...}, ...]
- default:       <TOOLCALL>/<|python_tag|> or bare JSON

A payload may be one object, a JSON array of objects, or ';'-separated
objects; the function name is under "name", arguments under "arguments"
or "parameters" (json_parser.rs:114-126).
"""

from __future__ import annotations

import dataclasses
import json
import uuid


@dataclasses.dataclass
class ToolCall:
    name: str
    arguments: str  # JSON-encoded string (OpenAI wire format)
    id: str = dataclasses.field(
        default_factory=lambda: f"call-{uuid.uuid4().hex[:24]}")

    def to_openai(self, index: int = 0) -> dict:
        return {"id": self.id, "type": "function", "index": index,
                "function": {"name": self.name, "arguments": self.arguments}}


@dataclasses.dataclass
class ToolFormat:
    start_tokens: list[str]
    end_tokens: list[str]          # "" = runs to end of text
    bare_json_ok: bool = False     # a leading '{'/'[' starts a call


TOOL_FORMATS: dict[str, ToolFormat] = {
    "hermes": ToolFormat(["<tool_call>"], ["</tool_call>"]),
    "nemotron_deci": ToolFormat(["<TOOLCALL>"], ["</TOOLCALL>"]),
    "llama3_json": ToolFormat(["<|python_tag|>"], [""], bare_json_ok=True),
    "mistral": ToolFormat(["[TOOL_CALLS]"], [""]),
    "phi4": ToolFormat(["functools"], [""]),
    "default": ToolFormat(["<TOOLCALL>", "<|python_tag|>"], ["</TOOLCALL>", ""],
                          bare_json_ok=True),
}

NAME_KEYS = ("name",)
ARG_KEYS = ("arguments", "parameters")


def _calls_from_payload(payload: str) -> list[ToolCall]:
    """Parse one payload region: a JSON object, an array of objects, or
    ';'-separated objects."""
    payload = payload.strip()
    if not payload:
        return []
    candidates: list = []
    try:
        doc = json.loads(payload)
        candidates = doc if isinstance(doc, list) else [doc]
    except json.JSONDecodeError:
        for part in payload.split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                doc = json.loads(part)
            except json.JSONDecodeError:
                continue
            candidates.extend(doc if isinstance(doc, list) else [doc])
    out = []
    for item in candidates:
        if not isinstance(item, dict):
            continue
        name = next((item[k] for k in NAME_KEYS if k in item), None)
        args = next((item[k] for k in ARG_KEYS if k in item), None)
        if name is None:
            continue
        if not isinstance(args, str):
            args = json.dumps(args if args is not None else {})
        out.append(ToolCall(name=str(name), arguments=args))
    return out


def parse_tool_calls(text: str, parser: str) -> tuple[str, list[ToolCall]]:
    """Batch parse: returns (normal_text, calls). Unknown/None parser names
    pass the text through untouched."""
    fmt = TOOL_FORMATS.get(parser or "")
    if fmt is None:
        return text, []
    calls: list[ToolCall] = []
    normal: list[str] = []
    rest = text
    while rest:
        # Earliest start marker.
        hit = None
        for si, tok in enumerate(fmt.start_tokens):
            pos = rest.find(tok)
            if pos >= 0 and (hit is None or pos < hit[0]):
                hit = (pos, si, tok)
        if hit is None:
            if fmt.bare_json_ok and rest.lstrip()[:1] in ("{", "["):
                got = _calls_from_payload(rest)
                if got:
                    calls.extend(got)
                    rest = ""
                    continue
            normal.append(rest)
            break
        pos, si, tok = hit
        normal.append(rest[:pos])
        after = rest[pos + len(tok):]
        end_tok = (fmt.end_tokens[si]
                   if si < len(fmt.end_tokens) else "").strip()
        if end_tok:
            end = after.find(end_tok)
            if end < 0:
                payload, rest = after, ""
            else:
                payload, rest = after[:end], after[end + len(end_tok):]
        else:
            payload, rest = after, ""
        calls.extend(_calls_from_payload(payload))
    return "".join(normal).strip("\n"), calls


class StreamingToolCallParser:
    """Incremental tool-call extraction: feed text deltas; content before
    any marker streams through, everything after is jailed until finish.
    A marker PREFIX at the buffer tail is held back too, so markers split
    across deltas never leak."""

    def __init__(self, parser: str):
        self.fmt = TOOL_FORMATS.get(parser or "")
        self.buf = ""
        self.jailed = False
        self._emitted = False  # any content already streamed out

    def _tail_holdback(self) -> int:
        """Length of the longest start-token prefix the buffer ends with."""
        assert self.fmt is not None
        best = 0
        for tok in self.fmt.start_tokens:
            for k in range(min(len(tok), len(self.buf)), 0, -1):
                if self.buf.endswith(tok[:k]):
                    best = max(best, k)
                    break
        return best

    def feed(self, delta: str) -> str:
        """Returns the content safe to emit now ('' while jailed)."""
        if self.fmt is None:
            return delta
        self.buf += delta
        if self.jailed:
            return ""
        for tok in self.fmt.start_tokens:
            if tok in self.buf:
                pos = self.buf.find(tok)
                visible = self.buf[:pos]
                self.buf = self.buf[pos:]
                self.jailed = True
                if visible:
                    self._emitted = True
                return visible
        # Bare-JSON only counts at RESPONSE start (matching the batch
        # parser's leading-JSON rule) — mid-answer JSON is just content.
        if (self.fmt.bare_json_ok and not self._emitted
                and self.buf.lstrip()[:1] in ("{", "[")):
            self.jailed = True
            return ""
        hold = self._tail_holdback()
        visible = self.buf[:len(self.buf) - hold] if hold else self.buf
        self.buf = self.buf[len(visible):]
        if visible.strip():
            self._emitted = True
        return visible

    def finish(self) -> tuple[str, list[ToolCall]]:
        """Flush: parse anything jailed; returns (trailing_text, calls) —
        non-call text around the parsed blocks is preserved."""
        if self.fmt is None or not self.buf:
            return "", []
        text, calls = parse_tool_calls(self.buf, _fmt_name(self.fmt))
        self.buf = ""
        return text, calls


def _fmt_name(fmt: ToolFormat) -> str:
    for name, f in TOOL_FORMATS.items():
        if f is fmt:
            return name
    return "default"


# ---------------------------------------------------------------------------
# Reasoning (think-tag) parsing — reference reasoning/deepseek_r1_parser.rs
# ---------------------------------------------------------------------------

REASONING_FORMATS: dict[str, tuple[str, str, bool]] = {
    # name: (open, close, starts_in_reasoning) — DeepSeek-R1 templates
    # often omit the opening tag (generation starts inside the think
    # block), hence the basic/forced split.
    "deepseek_r1": ("<think>", "</think>", True),
    "basic": ("<think>", "</think>", False),
}


def parse_reasoning(text: str, parser: str) -> tuple[str, str]:
    """Batch split -> (content, reasoning_content)."""
    fmt = REASONING_FORMATS.get(parser or "")
    if fmt is None:
        return text, ""
    open_t, close_t, starts_in = fmt
    reasoning: list[str] = []
    content: list[str] = []
    rest = text
    in_think = starts_in and not rest.lstrip().startswith(open_t)
    while rest:
        if in_think:
            end = rest.find(close_t)
            if end < 0:
                reasoning.append(rest)
                break
            reasoning.append(rest[:end])
            rest = rest[end + len(close_t):]
            in_think = False
        else:
            start = rest.find(open_t)
            if start < 0:
                content.append(rest)
                break
            content.append(rest[:start])
            rest = rest[start + len(open_t):]
            in_think = True
    return "".join(content).strip("\n"), "".join(reasoning).strip("\n")


class StreamingReasoningParser:
    """Incremental think-tag splitting: feed(delta) ->
    (content_delta, reasoning_delta), with tag-prefix holdback at the
    buffer tail."""

    def __init__(self, parser: str):
        self.fmt = REASONING_FORMATS.get(parser or "")
        self.buf = ""
        self.started = False
        self.in_think = False

    def feed(self, delta: str) -> tuple[str, str]:
        if self.fmt is None:
            return delta, ""
        open_t, close_t, starts_in = self.fmt
        self.buf += delta
        if not self.started:
            s = self.buf.lstrip()
            if not s:
                return "", ""
            if starts_in and open_t.startswith(s):
                # Could still become the opening tag: hold until decidable.
                return "", ""
            self.started = True
            if starts_in and not s.startswith(open_t):
                self.in_think = True
        content, reasoning = [], []
        while True:
            tok = close_t if self.in_think else open_t
            pos = self.buf.find(tok)
            if pos >= 0:
                (reasoning if self.in_think else content).append(
                    self.buf[:pos])
                self.buf = self.buf[pos + len(tok):]
                self.in_think = not self.in_think
                continue
            # Hold back a possible split tag at the tail.
            hold = 0
            for k in range(min(len(tok), len(self.buf)), 0, -1):
                if self.buf.endswith(tok[:k]):
                    hold = k
                    break
            emit = self.buf[:len(self.buf) - hold]
            self.buf = self.buf[len(self.buf) - hold:]
            (reasoning if self.in_think else content).append(emit)
            break
        return "".join(content), "".join(reasoning)

    def finish(self) -> tuple[str, str]:
        out = self.feed("")
        tail_c, tail_r = ("", self.buf) if self.in_think else (self.buf, "")
        self.buf = ""
        return out[0] + tail_c, out[1] + tail_r
