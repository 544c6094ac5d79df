"""The port's tokenizer.json reader (``dynamo_tpu_torch.llm.bpe``) and its
``Tokenizer`` / ``DecodeStream`` / ``StopSequenceChecker`` against the
``tokenizers`` library and the JAX package's wrappers, id for id and
string for string.

Four tokenizers: the repo's test tokenizer (the committed fixture); a
Llama-3-style one (BPE with ``ignore_merges``, ``Split`` on the Llama-3
pattern then ``ByteLevel`` without its regex, a ``TemplateProcessing``
post-processor); a Qwen2-style one (``NFC`` and the ``\\p{N}``
pattern); and a byte-level one without the full byte alphabet, whose
missing bytes become a fused ``<unk>``. The texts are a fixed table and
a hypothesis strategy over the code points Python's ``unicodedata``
assigns.

One Unicode-table difference shows: the regex engine inside
``tokenizers`` (Oniguruma) has Unicode 16.0's letters and numbers, and
Python 3.12's ``unicodedata`` has Unicode 15.0, where they are unassigned.
``bpe.py`` adds them to its classes by hand;
``test_unicode16_letters_and_numbers`` holds it to that.
"""

import random

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, processors, trainers)

from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu_torch.llm import bpe
from dynamo_tpu_torch.llm import tokenizer as ttok

torch.set_num_threads(1)

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
QWEN2_PATTERN = LLAMA3_PATTERN.replace(r"\p{N}{1,3}", r"\p{N}")
SPECIALS = ["<|begin_of_text|>", "<|eot_id|>", "<|im_start|>", "<|im_end|>"]
NAMES = ["test", "llama3", "qwen2", "unk"]
CORPUS = [
    "hello world this is a test of the gpu native serving framework",
    "the quick brown fox jumps over the lazy dog 0123456789 12345",
    "def main(): return [i for i in range(10)]  # don't we'll they're",
    "日本語のテキスト 中文文本 한국어 텍스트 émoji 😀🎉 café naïve",
    "line one\r\nline two\n\n\ttabbed   spaces",
]
TEXTS = CORPUS + [
    "", " ", "  hi", "a\u001cb\u001fc", "x\u0085y z　w",
    "123456789 1234 ٣٤٥ ½ ①", "'S 'ſ 'LL 'Ve I'M", "é é ñ",
    "combining é ä क्ष",
    "<|im_start|>user\nhi<|im_end|>\n<|eot_id|>x<|im_end|><|im_end",
    "<|begin_of_text|><|endoftext|> <|im_start|>assistant\n",
    "\t\t  \n \r\n\r\n   \t", "𝒳𝒴 🇯🇵 👩‍👩‍👧 🎉🎉", "don't stop 12 345 6789",
    "tabs\tand   runs    of spaces", "emoji 😀 cjk 你好世界 mixed123abc",
]


def _build(kind: str) -> Tokenizer:
    if kind == "unk":
        # No initial alphabet: bytes the corpus lacks become one fused
        # <unk> per run.
        hf = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True))
        hf.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        hf.decoder = decoders.ByteLevel()
        hf.train_from_iterator(CORPUS[:3], trainers.BpeTrainer(
            vocab_size=300, special_tokens=["<unk>", "<|im_end|>"]))
        return hf
    hf = Tokenizer(models.BPE(unk_token=None,
                              ignore_merges=(kind == "llama3")))
    if kind == "qwen2":
        hf.normalizer = normalizers.NFC()
    pattern = LLAMA3_PATTERN if kind == "llama3" else QWEN2_PATTERN
    hf.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    hf.decoder = decoders.ByteLevel()
    hf.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=700, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    if kind == "llama3":
        bos = "<|begin_of_text|>"
        hf.post_processor = processors.TemplateProcessing(
            single=f"{bos} $A", special_tokens=[(bos, hf.token_to_id(bos))])
    return hf


@pytest.fixture(scope="module")
def pairs():
    """name -> (tokenizers.Tokenizer, JAX Tokenizer, port Tokenizer)."""
    out = {}
    for name in NAMES:
        hf = (jtok.make_test_tokenizer()._hf if name == "test"
              else _build(name))
        blob = hf.to_str().encode()
        out[name] = (hf, jtok.Tokenizer(hf), ttok.Tokenizer.from_bytes(blob))
    return out


def test_fixture_is_the_reference_test_tokenizer():
    assert ttok.TEST_TOKENIZER.read_bytes() == \
        jtok.make_test_tokenizer().to_bytes()
    tok = ttok.make_test_tokenizer()
    assert tok.vocab_size == 361
    assert tok.token_to_id("<|endoftext|>") is not None
    assert tok.token_to_id("<|im_end|>") is not None
    assert tok.token_to_id("<|im_start|>") is None


def _check_text(hf, jt, tt, text):
    for add in (False, True):
        want = hf.encode(text, add_special_tokens=add).ids
        assert tt.encode(text, add_special_tokens=add) == want, (text, add)
    ids = jt.encode(text)
    assert tt.encode(text) == ids
    # Ids outside the vocab decode to nothing, as in tokenizers.
    for seq in (ids, ids + [10**6, 5], [hf.get_vocab_size() + 3] + ids):
        for skip in (True, False):
            assert tt.decode(seq, skip) == hf.decode(seq, skip), (text, seq)
    for k in range(len(ids) + 1):
        assert tt.decode(ids[:k]) == jt.decode(ids[:k])


@pytest.mark.parametrize("name", NAMES)
def test_fixed_table(pairs, name):
    hf, jt, tt = pairs[name]
    assert tt.vocab_size == jt.vocab_size == hf.get_vocab_size()
    assert tt.eos_token_ids() == jt.eos_token_ids()
    for tok in SPECIALS + ["<|endoftext|>", "hello", "Ġthe", "nope"]:
        assert tt.token_to_id(tok) == hf.token_to_id(tok)
    for text in TEXTS:
        _check_text(hf, jt, tt, text)


_TEXT = st.lists(st.one_of(
    st.sampled_from(list(" \n\r\t'sStTdD0123456789abcXYZ.,!-é")
                    + SPECIALS[1:]),
    st.characters(exclude_categories=("Cn", "Cs"))), max_size=40).map(
        "".join)


@pytest.mark.parametrize("name", NAMES)
@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_TEXT)
def test_hypothesis_texts(pairs, name, text):
    _check_text(*pairs[name], text)


def test_unicode16_letters_and_numbers(pairs):
    """Unicode 16.0 letters and numbers, unassigned for Python 3.12's
    ``unicodedata`` (Unicode 15.0), pre-tokenize as ``tokenizers`` does."""
    points = [a for a, _ in bpe._UNICODE16_L + bpe._UNICODE16_N] + \
        [b for _, b in bpe._UNICODE16_L + bpe._UNICODE16_N]
    rng = random.Random(0)
    texts = ["".join(chr(c) for c in points)]
    texts += ["".join(rng.choice([chr(rng.choice(points)), "1", " ", "a",
                                  "'", "."]) for _ in range(24))
              for _ in range(30)]
    for name in ("llama3", "qwen2", "test"):
        for text in texts:
            _check_text(*pairs[name], text)


def _stream(decoder_cls, tok, ids):
    stream = decoder_cls(tok)
    return [stream.step(t) for t in ids]


@pytest.mark.parametrize("name", ["test", "llama3", "qwen2"])
def test_decode_stream_and_stop_strings(pairs, name):
    """The same delta sequence as the JAX DecodeStream, None while a
    multi-byte character is split across tokens; stop strings split across
    deltas emit the same text."""
    _, jt, tt = pairs[name]
    rng = random.Random(1)
    split_seen = False
    for text in TEXTS:
        ids = jt.encode(text)
        for seq in (ids, ids[:3] + [10**6] + ids[3:]):
            want = _stream(jtok.DecodeStream, jt, seq)
            assert _stream(ttok.DecodeStream, tt, seq) == want
            split_seen |= any(d is None for d in want) and bool(seq)
        deltas = [d for d in _stream(ttok.DecodeStream, tt, ids) if d]
        stops = [text[i:i + rng.randint(1, 4)]
                 for i in sorted(rng.sample(range(len(text)),
                                            min(2, len(text))))]
        for stop_set in (stops, ["zz"], ["\n", "o w"], []):
            jc = jtok.StopSequenceChecker(stop_set)
            tc = ttok.StopSequenceChecker(stop_set)
            for d in deltas:
                assert tc.append(d) == jc.append(d), (text, stop_set, d)
            assert tc.flush() == jc.flush()
    assert split_seen, "no multi-byte character was split across tokens"


def test_reader_refuses_what_it_does_not_read(pairs):
    import json
    spec = json.loads(pairs["llama3"][0].to_str())
    bad = [("model", dict(spec["model"], type="WordPiece"), "WordPiece"),
           ("normalizer", {"type": "NFKD"}, "NFKD"),
           ("pre_tokenizer", {"type": "Metaspace"}, "Metaspace"),
           ("decoder", {"type": "WordPiece"}, "WordPiece"),
           ("pre_tokenizer", {"type": "Split", "behavior": "Removed",
                              "invert": False,
                              "pattern": {"Regex": " "}}, "Removed"),
           ("pre_tokenizer", {"type": "Split", "behavior": "Isolated",
                              "invert": False,
                              "pattern": {"Regex": r"\p{Lu}+"}}, "Lu")]
    for key, value, word in bad:
        with pytest.raises(ValueError, match=word):
            bpe.BPETokenizer(dict(spec, **{key: value}))


def test_long_prompt_encodes_fast(pairs):
    import time
    _, _, tt = pairs["llama3"]
    text = " ".join(CORPUS * 100)
    t0 = time.perf_counter()
    n = len(tt.encode(text))
    assert n > 6000
    assert time.perf_counter() - t0 < 1.0
