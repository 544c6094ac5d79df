"""Tokenizer with incremental (streaming) detokenization (copy of
``dynamo_tpu.llm.tokenizer`` on the port's own ``tokenizer.json`` reader,
``llm/bpe.py``, in place of the ``tokenizers`` library).

``DecodeStream`` emits UTF-8-safe text deltas token by token; the
``StopSequenceChecker`` holds back a tail that may still become a stop
string. ``from_file`` reads a ``tokenizer.json`` or, by its ``.gguf``
suffix, a GGUF file's embedded vocabulary (``llm/gguf.py``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence as Seq

from dynamo_tpu_torch.llm.bpe import BPETokenizer

TEST_TOKENIZER = Path(__file__).with_name("test_tokenizer.json")


class Tokenizer:
    """A ``tokenizer.json`` loaded for encode and decode."""

    def __init__(self, bpe: BPETokenizer, blob: bytes):
        self._bpe = bpe
        self._blob = blob
        # Explicit EOS ids (e.g. from GGUF metadata) override the
        # name-convention discovery in eos_token_ids().
        self.eos_override: list[int] | None = None

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "Tokenizer":
        if str(path).endswith(".gguf"):
            from dynamo_tpu_torch.llm.gguf import tokenizer_from_gguf
            return tokenizer_from_gguf(str(path))
        return cls.from_bytes(Path(path).read_bytes())

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Tokenizer":
        return cls(BPETokenizer.from_str(blob.decode("utf-8")), blob)

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "Tokenizer":
        """Load from a local model directory containing tokenizer.json."""
        path = os.path.join(model_dir, "tokenizer.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no tokenizer.json under {model_dir}")
        return cls.from_file(path)

    def to_bytes(self) -> bytes:
        return self._blob

    @property
    def vocab_size(self) -> int:
        return self._bpe.vocab_size

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return self._bpe.encode(text, add_special_tokens)

    def decode(self, ids: Seq[int], skip_special_tokens: bool = True) -> str:
        """Ids outside the vocab decode to nothing."""
        return self._bpe.decode(ids, skip_special_tokens)

    def token_to_id(self, token: str) -> int | None:
        return self._bpe.token_to_id(token)

    def eos_token_ids(self) -> list[int]:
        """Best-effort EOS discovery from common conventions."""
        if self.eos_override is not None:
            return list(self.eos_override)
        ids = []
        for tok in ("</s>", "<|endoftext|>", "<|eot_id|>", "<|end_of_text|>",
                    "<|im_end|>", "<eos>"):
            tid = self.token_to_id(tok)
            if tid is not None:
                ids.append(tid)
        return ids


class DecodeStream:
    """Incremental detokenizer.

    ``step(token_id)`` returns the new text produced by appending the token,
    or None when the bytes so far don't yet form valid complete text (e.g.
    half of a multi-byte grapheme): decode(ids[prefix:]) against
    decode(ids[prefix:read]), emitting the suffix only when it is complete
    and doesn't end in a replacement char.
    """

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        self.ids: list[int] = []
        self._prefix_offset = 0
        self._read_offset = 0

    def step(self, token_id: int) -> str | None:
        self.ids.append(token_id)
        prefix_text = self._tok.decode(
            self.ids[self._prefix_offset:self._read_offset], self._skip)
        new_text = self._tok.decode(self.ids[self._prefix_offset:], self._skip)
        if new_text.endswith("�"):
            # Incomplete UTF-8 sequence: wait for more tokens.
            return None
        if len(new_text) <= len(prefix_text):
            return None
        delta = new_text[len(prefix_text):]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self.ids)
        return delta


class StopSequenceChecker:
    """Streaming stop-string detection over appended text deltas.

    Holds back a tail of at most ``max_stop_len - 1`` chars that is a prefix
    of some stop string, so a stop string split across deltas is still
    caught. ``append`` returns (emit_text, matched), emit_text being the
    safe-to-emit portion.
    """

    def __init__(self, stops: list[str]):
        self.stops = [s for s in stops if s]
        self._held = ""
        self._max = max((len(s) for s in self.stops), default=0)

    def append(self, delta: str) -> tuple[str, bool]:
        if not self.stops:
            return delta, False
        buf = self._held + delta
        # Earliest match across all stop strings wins, so no text past an
        # earlier stop leaks when a later-listed stop also matches.
        best = -1
        for stop in self.stops:
            idx = buf.find(stop)
            if idx != -1 and (best == -1 or idx < best):
                best = idx
        if best != -1:
            self._held = ""
            return buf[:best], True
        keep = min(self._max - 1, len(buf))
        hold = 0
        for k in range(keep, 0, -1):
            tail = buf[-k:]
            if any(s.startswith(tail) for s in self.stops):
                hold = k
                break
        self._held = buf[len(buf) - hold:] if hold else ""
        emit = buf[:len(buf) - hold] if hold else buf
        return emit, False

    def flush(self) -> str:
        held, self._held = self._held, ""
        return held


def make_test_tokenizer() -> Tokenizer:
    """The repo's small byte-level BPE test tokenizer (vocab 361, special
    tokens ``<|endoftext|>`` and ``<|im_end|>``), read from the committed
    ``test_tokenizer.json``: the bytes the JAX package's
    ``make_test_tokenizer()`` builds. For tests and smoke runs, not for
    real models."""
    return Tokenizer.from_file(TEST_TOKENIZER)
