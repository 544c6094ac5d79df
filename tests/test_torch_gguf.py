"""GGUF tokenizers in the port (``dynamo_tpu_torch/llm/gguf.py``) against
the JAX package's ``dynamo_tpu.llm.gguf`` on the same files.

The files are real GGUF v3 containers of metadata, written by the port's
``write_metadata`` and by ``tests/test_gguf.py``'s own writer, carrying the
test tokenizer's byte-level BPE vocab and merges. Held: ``read_metadata``
equal; ids equal on hypothesis texts and decode equal; the port's
``to_bytes()`` blob is a ``tokenizer.json`` that ``tokenizers`` (through
the JAX ``Tokenizer.from_bytes``) reads to the same ids, byte-equal to the
reference's own blob; ``eos_override`` from the metadata; and
``test_gguf.py``'s error cases raise alike in both packages.
"""

import json
import struct

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_gguf import _kv_str_array, _kv_string, _kv_u32, write_gguf

from dynamo_tpu.llm import gguf as jg
from dynamo_tpu.llm.tokenizer import Tokenizer as JTokenizer
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu_torch.llm import gguf as tg
from dynamo_tpu_torch.llm.tokenizer import Tokenizer as TTokenizer


def _vocab_and_merges():
    spec = json.loads(j_test_tokenizer().to_bytes())["model"]
    tokens = [t for t, _ in sorted(spec["vocab"].items(),
                                   key=lambda kv: kv[1])]
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in spec["merges"]]
    return tokens, merges


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same tokenizer written by the port's writer and by
    test_gguf.py's."""
    d = tmp_path_factory.mktemp("gguf")
    tokens, merges = _vocab_and_merges()
    port_path = str(d / "port.gguf")
    tg.write_metadata(port_path, {
        "general.architecture": "llama", "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
        "tokenizer.ggml.eos_token_id": 1, "general.quantized": True,
        "general.scale": 0.5, "general.big": -5})
    ref_path = d / "ref.gguf"
    write_gguf(ref_path, [
        _kv_string("general.architecture", "llama"),
        _kv_string("tokenizer.ggml.model", "gpt2"),
        _kv_str_array("tokenizer.ggml.tokens", tokens),
        _kv_str_array("tokenizer.ggml.merges", merges),
        _kv_u32("tokenizer.ggml.eos_token_id", 0)])
    return port_path, str(ref_path)


@pytest.fixture(scope="module")
def pair(files):
    path = files[0]
    return jg.tokenizer_from_gguf(path), tg.tokenizer_from_gguf(path)


@pytest.mark.parametrize("which", [0, 1], ids=["port-writer", "ref-writer"])
def test_read_metadata_equal(files, which):
    meta = tg.read_metadata(files[which])
    assert meta == jg.read_metadata(files[which])
    assert meta["gguf.version"] == 3
    assert isinstance(meta["tokenizer.ggml.tokens"], list)


def test_writer_types(files):
    meta = tg.read_metadata(files[0])
    assert meta["general.quantized"] is True
    assert meta["general.scale"] == 0.5 and meta["general.big"] == -5


@pytest.mark.parametrize("which", [0, 1], ids=["port-writer", "ref-writer"])
def test_ids_and_eos_equal(files, which):
    j, t = (jg.tokenizer_from_gguf(files[which]),
            tg.tokenizer_from_gguf(files[which]))
    for text in ("hello world", "the quick brown fox", "a b c", "",
                 "def main(): return [i for i in range(10)]"):
        assert t.encode(text) == j.encode(text), text
        assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    assert t.eos_token_ids() == j.eos_token_ids() == [1 - which]
    assert t.vocab_size == j.vocab_size


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=60))
def test_ids_equal_on_any_text(pair, text):
    j, t = pair
    assert t.encode(text) == j.encode(text)
    ids = j.encode(text)
    assert t.decode(ids) == j.decode(ids)


def test_blob_reads_back_in_tokenizers(pair):
    """A JAX frontend fetches the port worker's blob: tokenizers reads it
    to the same ids; eos_override does not travel, on either side."""
    j, t = pair
    assert t.to_bytes() == j.to_bytes()
    back = JTokenizer.from_bytes(t.to_bytes())
    for text in ("hello world again", "the lazy dog 0123", "é 日本 \n\t x"):
        assert back.encode(text) == j.encode(text) == t.encode(text)
    assert TTokenizer.from_bytes(t.to_bytes()).eos_override is None


def test_from_file_dispatches_on_extension(files):
    tok = TTokenizer.from_file(files[1])
    assert tok.encode("hello") and tok.eos_token_ids() == [0]


def _both_raise(path, match):
    for fn in (jg.tokenizer_from_gguf, tg.tokenizer_from_gguf):
        with pytest.raises(ValueError, match=match):
            fn(str(path))


def test_errors_raise_alike(tmp_path):
    bad = tmp_path / "x.gguf"
    bad.write_bytes(b"NOPE" + b"\x00" * 16)
    _both_raise(bad, "not a GGUF")
    sp = tmp_path / "sp.gguf"
    write_gguf(sp, [_kv_string("tokenizer.ggml.model", "llama"),
                    _kv_str_array("tokenizer.ggml.tokens", ["a", "b"])])
    _both_raise(sp, "unsupported")
    none = tmp_path / "none.gguf"
    write_gguf(none, [_kv_string("tokenizer.ggml.model", "gpt2")])
    _both_raise(none, "no tokenizer.ggml.tokens")
    old = tmp_path / "v1.gguf"
    old.write_bytes(b"GGUF" + struct.pack("<I", 1) + b"\x00" * 16)
    _both_raise(old, "GGUF v1 unsupported")
    cut = tmp_path / "cut.gguf"
    raw = (tmp_path / "sp.gguf").read_bytes()
    cut.write_bytes(raw[:30])
    _both_raise(cut, "truncated")
