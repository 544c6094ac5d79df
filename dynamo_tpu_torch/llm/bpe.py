"""A ``tokenizer.json`` reader with byte-level BPE, on the standard library.

It encodes and decodes as the ``tokenizers`` library does (the engine
behind ``dynamo_tpu.llm.tokenizer.Tokenizer``) for the files of the
model families the repo serves (GPT-2-style, Llama-3, Qwen2):

- ``added_tokens`` are matched first, leftmost-longest; tokens with
  ``normalized: false`` on the raw text, the others after normalization;
- the normalizer is ``NFC`` or none;
- the pre-tokenizer is ``ByteLevel`` (with or without the GPT-2 regex,
  no prefix space), ``Split`` (a regex, behavior ``Isolated``), or a
  ``Sequence`` of these;
- the model is ``BPE`` (``vocab``, ``merges``, ``ignore_merges``,
  ``unk_token``, ``fuse_unk``), merged pair by pair in rank order as
  ``tokenizers``' ``Word::merge_all`` does;
- the post-processor is none, ``ByteLevel``, ``TemplateProcessing`` or a
  ``Sequence`` of them; the decoder is ``ByteLevel`` or none.

Any other component raises ``ValueError`` naming it: nothing falls back.

The library's regexes run on Oniguruma, whose ``\\p{L}``, ``\\p{N}`` and
``\\s`` differ from Python's ``re`` (which has no ``\\p{..}``, and whose
``\\s`` is ``str.isspace``: that takes U+001C-U+001F, Unicode's White_Space
does not). ``_translate`` rewrites a pattern onto explicit classes built
from ``unicodedata`` at first use.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata

# Unicode 16.0 assigned these code points to the letter (L) and number (N)
# categories. The regex engine inside ``tokenizers`` 0.22 knows them;
# Python 3.12's ``unicodedata`` (Unicode 15.0) does not, so they are added
# to the classes by hand.
_UNICODE16_L = (
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF),
    (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_UNICODE16_N = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x16130, 0x16139), (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9),
    (0x1E5F1, 0x1E5FA))

# The GPT-2 pattern of the ByteLevel pre-tokenizer (use_regex=true).
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

# tokenizers' BPE keeps at most this many words in its cache.
CACHE_CAPACITY = 10_000


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table, n = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + n)
            n += 1
    return table


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}
_BYTE_TRANS = [BYTE_TO_CHAR[b] for b in range(256)]


def _class_body(ranges) -> str:
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                   for a, b in ranges)


def _merge_ranges(points) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for c in sorted(set(points)):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [(a, b) for a, b in out]


@functools.cache
def _classes() -> dict[str, str]:
    """Bodies of the ``[...]`` classes for ``\\p{L}``, ``\\p{N}`` and
    ``\\s`` (Oniguruma's Unicode ``\\s``: U+0009-U+000D, U+0085 and the
    Zs, Zl and Zp categories)."""
    letters, numbers, spaces = [], [], [0x9, 0xA, 0xB, 0xC, 0xD, 0x85]
    for c in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(c))
        if cat[0] == "L":
            letters.append(c)
        elif cat[0] == "N":
            numbers.append(c)
        elif cat in ("Zs", "Zl", "Zp"):
            spaces.append(c)
    for extra, into in ((_UNICODE16_L, letters), (_UNICODE16_N, numbers)):
        for a, b in extra:
            into.extend(range(a, b + 1))
    return {"L": _class_body(_merge_ranges(letters)),
            "N": _class_body(_merge_ranges(numbers)),
            "s": _class_body(_merge_ranges(spaces))}


def _translate(pattern: str) -> str:
    """An Oniguruma pattern of the kinds tokenizer files use, rewritten for
    Python's ``re`` with explicit ``\\p{L}``, ``\\p{N}``, ``\\s`` and
    ``\\S`` classes. Other class escapes raise ``ValueError``."""
    cls = _classes()
    out, i, in_class = [], 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            if i + 1 >= len(pattern):
                raise ValueError(f"pattern ends in a backslash: {pattern!r}")
            nxt = pattern[i + 1]
            i += 2
            if nxt == "p":
                end = pattern.find("}", i)
                name = pattern[i + 1:end] if pattern[i:i + 1] == "{" else ""
                if name not in ("L", "N"):
                    raise ValueError(
                        f"pattern class \\p{{{name}}} is not supported in "
                        f"{pattern!r}")
                i = end + 1
                out.append(cls[name] if in_class else f"[{cls[name]}]")
            elif nxt == "s":
                out.append(cls["s"] if in_class else f"[{cls['s']}]")
            elif nxt == "S" and not in_class:
                out.append(f"[^{cls['s']}]")
            elif nxt in "rnt" or not nxt.isalnum():
                out.append("\\" + nxt)
            else:
                raise ValueError(f"pattern escape \\{nxt} is not supported "
                                 f"in {pattern!r}")
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
        elif ch == "]" and in_class:
            in_class = False
            out.append(ch)
        else:
            out.append(ch)
        i += 1
    return "".join(out)


@functools.cache
def _compile(pattern: str) -> re.Pattern:
    return re.compile(_translate(pattern))


def _split_isolated(regex: re.Pattern, text: str) -> list[str]:
    """Every match and every gap between matches, in order, none empty
    (SplitDelimiterBehavior::Isolated)."""
    out, last = [], 0
    for m in regex.finditer(text):
        if m.start() > last:
            out.append(text[last:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        last = m.end()
    if last < len(text):
        out.append(text[last:])
    return out


def _unsupported(what: str, spec) -> ValueError:
    kind = spec.get("type") if isinstance(spec, dict) else spec
    return ValueError(f"tokenizer.json: {what} {kind!r} is not supported")


# -- normalizer ---------------------------------------------------------------

def _normalizer(spec):
    """A function str -> str, or None for no normalizer."""
    if spec is None:
        return None
    if spec.get("type") == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    raise _unsupported("normalizer", spec)


# -- pre-tokenizer ------------------------------------------------------------

def _pre_tokenizer(spec) -> list:
    """A list of steps, each a function list[str] -> list[str]."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for s in spec["pretokenizers"]
                for step in _pre_tokenizer(s)]
    if kind == "Split":
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise ValueError(
                f"tokenizer.json: Split behavior {spec.get('behavior')!r} "
                f"(invert={spec.get('invert')}) is not supported")
        if "Regex" not in spec["pattern"]:
            raise _unsupported("Split pattern", str(spec["pattern"]))
        regex = _compile(spec["pattern"]["Regex"])
        return [lambda pieces: [p for piece in pieces
                                for p in _split_isolated(regex, piece)]]
    if kind == "ByteLevel":
        if spec.get("add_prefix_space"):
            raise ValueError("tokenizer.json: ByteLevel add_prefix_space is "
                             "not supported")
        regex = _compile(GPT2_PATTERN) if spec.get("use_regex", True) \
            else None

        def byte_level(pieces: list[str]) -> list[str]:
            out = []
            for piece in pieces:
                parts = _split_isolated(regex, piece) if regex else [piece]
                out.extend("".join(_BYTE_TRANS[b] for b in p.encode("utf-8"))
                           for p in parts)
            return out
        return [byte_level]
    raise _unsupported("pre_tokenizer", spec)


# -- model --------------------------------------------------------------------

class BPEModel:
    """The ``BPE`` model of a tokenizer.json: vocab, ranked merges and a
    per-word cache."""

    def __init__(self, spec: dict):
        if spec.get("type") != "BPE":
            raise _unsupported("model", spec)
        if spec.get("dropout") not in (None, 0, 0.0):
            raise ValueError("tokenizer.json: BPE dropout is not supported")
        for key in ("byte_fallback", "continuing_subword_prefix",
                    "end_of_word_suffix"):
            if spec.get(key):
                raise ValueError(f"tokenizer.json: BPE {key} is not "
                                 "supported")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        unk = spec.get("unk_token")
        if unk is not None and unk not in self.vocab:
            raise ValueError(f"tokenizer.json: unk_token {unk!r} is not in "
                             "the vocab")
        self.unk_id = None if unk is None else self.vocab[unk]
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        # (left id, right id) -> (rank, merged id)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, merge in enumerate(spec["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            try:
                key = (self.vocab[a], self.vocab[b])
                self.merges[key] = (rank, self.vocab[a + b])
            except KeyError as exc:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names "
                                 f"a token outside the vocab: {exc}") from None
        self._cache: dict[str, tuple[int, ...]] = {}

    def tokenize(self, word: str) -> tuple[int, ...]:
        if not word:
            return ()
        if self.ignore_merges and word in self.vocab:
            return (self.vocab[word],)
        hit = self._cache.get(word)
        if hit is None:
            hit = tuple(self._merge_word(word))
            if len(self._cache) < CACHE_CAPACITY:
                self._cache[word] = hit
        return hit

    def _symbols(self, word: str) -> list[int]:
        """One id per character; characters outside the vocab become the
        unk token, fused if asked, or are dropped when there is none."""
        ids: list[int] = []
        unk = self.unk_id
        last_was_unk = False
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                ids.append(tid)
                last_was_unk = False
            elif unk is not None:
                if not (self.fuse_unk and last_was_unk):
                    ids.append(unk)
                last_was_unk = True
        return ids

    def _merge_word(self, word: str) -> list[int]:
        """tokenizers' ``Word::merge_all``: pop the lowest (rank, position)
        pair, skip it if it expired, merge it, push the pairs it forms with
        its neighbours."""
        ids = self._symbols(word)
        n = len(ids)
        alive = [True] * n
        prev = list(range(-1, n - 1))
        nxt = [i + 1 if i + 1 < n else -1 for i in range(n)]
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prev[nxt[pos]] = pos
            if prev[pos] != -1:
                m = merges.get((ids[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, ids[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(ids, alive) if a]


# -- post-processor and decoder -----------------------------------------------

def _post_processor(spec):
    """A function (ids) -> ids for ``add_special_tokens=True``; None when
    the post-processor adds nothing."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "ByteLevel":
        return None
    if kind == "Sequence":
        steps = [p for p in (_post_processor(s) for s in spec["processors"])
                 if p is not None]

        def run(ids: list[int]) -> list[int]:
            for step in steps:
                ids = step(ids)
            return ids
        return run
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens") or {}
        template = []
        for item in spec["single"]:
            if "SpecialToken" in item:
                template.append(
                    list(specials[item["SpecialToken"]["id"]]["ids"]))
            elif item.get("Sequence", {}).get("id") == "A":
                template.append(None)
            else:
                raise _unsupported("TemplateProcessing item", str(item))
        return lambda ids: [t for part in template
                            for t in (ids if part is None else part)]
    raise _unsupported("post_processor", spec)


def _byte_level_decode(tokens: list[str]) -> str:
    raw = bytearray()
    for tok in tokens:
        try:
            raw.extend(CHAR_TO_BYTE[c] for c in tok)
        except KeyError:
            raw.extend(tok.encode("utf-8"))
    return raw.decode("utf-8", errors="replace")


def _decoder(spec):
    if spec is None:
        return " ".join
    if spec.get("type") == "ByteLevel":
        return _byte_level_decode
    raise _unsupported("decoder", spec)


# -- the tokenizer ------------------------------------------------------------

class BPETokenizer:
    """Everything one ``tokenizer.json`` describes, for encode and decode."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, str(spec[key]))
        self.model = BPEModel(spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_steps = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.post = _post_processor(spec.get("post_processor"))
        self.decode_tokens = _decoder(spec.get("decoder"))
        self.added: dict[str, int] = {}
        self.special: set[str] = set()
        raw: dict[str, int] = {}
        normalized: dict[str, int] = {}
        for tok in spec.get("added_tokens") or []:
            for flag in ("single_word", "lstrip", "rstrip"):
                if tok.get(flag):
                    raise ValueError(f"tokenizer.json: added token "
                                     f"{tok['content']!r} sets {flag}, "
                                     "which is not supported")
            content = tok["content"]
            self.added[content] = tok["id"]
            if tok.get("special"):
                self.special.add(content)
            if not tok.get("normalized", True):
                raw[content] = tok["id"]
            elif self.normalize is not None:
                normalized[self.normalize(content)] = tok["id"]
            else:
                normalized[content] = tok["id"]
        self.added_by_id = {i: t for t, i in self.added.items()}
        # Added tokens that match the raw text, and those that match it
        # once normalized: (alternation, content -> id).
        self._raw = (self._alternation(raw), raw)
        self._normalized = (self._alternation(normalized), normalized)

    @classmethod
    def from_str(cls, text: str) -> "BPETokenizer":
        return cls(json.loads(text))

    @staticmethod
    def _alternation(tokens: list[str]):
        """Leftmost-longest matching of the tokens: at each position the
        alternation tries longer tokens first."""
        if not tokens:
            return None
        ordered = sorted(set(tokens), key=lambda t: (-len(t), t))
        return re.compile("|".join(re.escape(t) for t in ordered))

    @property
    def vocab_size(self) -> int:
        return len(set(self.model.vocab) | set(self.added))

    def token_to_id(self, token: str) -> int | None:
        tid = self.added.get(token)
        return tid if tid is not None else self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> str | None:
        tok = self.added_by_id.get(tid)
        return tok if tok is not None else self.model.id_to_token.get(tid)

    @staticmethod
    def _split_added(added, text: str):
        """(piece, id of the added token or None) in order."""
        regex, ids_of = added
        if regex is None:
            return [(text, None)] if text else []
        out, last = [], 0
        for m in regex.finditer(text):
            if m.start() > last:
                out.append((text[last:m.start()], None))
            out.append((m.group(), ids_of[m.group()]))
            last = m.end()
        if last < len(text):
            out.append((text[last:], None))
        return out

    def encode(self, text: str, add_special_tokens: bool = False
               ) -> list[int]:
        ids: list[int] = []
        for piece, tid in self._split_added(self._raw, text):
            if tid is not None:
                ids.append(tid)
                continue
            if self.normalize is not None:
                piece = self.normalize(piece)
            for sub, sub_id in self._split_added(self._normalized, piece):
                if sub_id is not None:
                    ids.append(sub_id)
                    continue
                words = [sub]
                for step in self.pre_steps:
                    words = step(words)
                for word in words:
                    ids.extend(self.model.tokenize(word))
        if add_special_tokens and self.post is not None:
            ids = self.post(ids)
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        return self.decode_tokens(tokens)
