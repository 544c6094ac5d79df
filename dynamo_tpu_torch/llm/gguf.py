"""GGUF metadata and tokenizer loading (counterpart of
``dynamo_tpu.llm.gguf``, on the standard library).

``read_metadata`` parses a GGUF v2/v3 container's metadata key-values (no
tensor data needed); ``tokenizer_from_gguf`` rebuilds the gpt2-style
byte-level BPE tokenizer of ``tokenizer.ggml.tokens`` and
``tokenizer.ggml.merges`` as the ``tokenizer.json`` the reference's
``tokenizers`` build would write (a BPE model of vocab and merges, the
ByteLevel pre-tokenizer with the GPT-2 regex and no prefix space, the
ByteLevel decoder, no post-processor), read by the port's ``bpe.py``.
That JSON is the tokenizer's ``to_bytes()`` blob, which
``tokenizers.Tokenizer.from_str`` reads to the same ids. ``eos_override``
comes from ``tokenizer.ggml.eos_token_id`` and, as in the reference, does
not travel in the blob. ``write_metadata`` writes a GGUF v3 file of
metadata alone (smoke runs and tests). GGUF is a little-endian TLV
container (spec: github.com/ggerganov/ggml/docs/gguf.md).
"""

from __future__ import annotations

import json
import struct
from typing import Any, BinaryIO

GGUF_MAGIC = b"GGUF"

# Metadata value type ids (gguf spec).
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = (
    6, 7, 8, 9, 10, 11, 12)

_SCALAR_FMT = {_T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
               _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
               _T_I64: "<q", _T_F64: "<d"}


def _read(fh: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    data = fh.read(size)
    if len(data) != size:
        raise ValueError("truncated GGUF file")
    return struct.unpack(fmt, data)[0]


def _read_string(fh: BinaryIO) -> str:
    n = _read(fh, "<Q")
    return fh.read(n).decode("utf-8", "replace")


def _read_value(fh: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        return _read(fh, _SCALAR_FMT[vtype])
    if vtype == _T_BOOL:
        return bool(_read(fh, "<B"))
    if vtype == _T_STRING:
        return _read_string(fh)
    if vtype == _T_ARRAY:
        etype = _read(fh, "<I")
        n = _read(fh, "<Q")
        return [_read_value(fh, etype) for _ in range(n)]
    raise ValueError(f"unknown GGUF value type {vtype}")


def read_metadata(path: str) -> dict[str, Any]:
    """Parse a GGUF file's metadata KVs (tensor info/data are skipped)."""
    with open(path, "rb") as fh:
        if fh.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path} is not a GGUF file")
        version = _read(fh, "<I")
        if version < 2:
            raise ValueError(f"GGUF v{version} unsupported (need >= 2)")
        _n_tensors = _read(fh, "<Q")
        n_kv = _read(fh, "<Q")
        meta: dict[str, Any] = {"gguf.version": version}
        for _ in range(n_kv):
            key = _read_string(fh)
            vtype = _read(fh, "<I")
            meta[key] = _read_value(fh, vtype)
        return meta


def _string(value: str) -> bytes:
    raw = value.encode("utf-8")
    return struct.pack("<Q", len(raw)) + raw


def _typed(value) -> tuple[int, bytes]:
    """(type id, payload) of a str, bool, int (u32, else i64), float (f32)
    or a list of one of these."""
    if isinstance(value, str):
        return _T_STRING, _string(value)
    if isinstance(value, bool):
        return _T_BOOL, struct.pack("<B", value)
    if isinstance(value, int):
        if 0 <= value < 2**32:
            return _T_U32, struct.pack("<I", value)
        return _T_I64, struct.pack("<q", value)
    if isinstance(value, float):
        return _T_F32, struct.pack("<f", value)
    if isinstance(value, list):
        items = [_typed(v) for v in value]
        etype = items[0][0] if items else _T_STRING
        if any(t != etype for t, _ in items):
            raise ValueError("a GGUF array holds one value type")
        return _T_ARRAY, (struct.pack("<IQ", etype, len(items))
                          + b"".join(p for _, p in items))
    raise ValueError(f"no GGUF value type for {type(value).__name__}")


def write_metadata(path: str, meta: dict[str, Any]) -> None:
    """Write a GGUF v3 file of ``meta``'s key-values and no tensors."""
    with open(path, "wb") as fh:
        fh.write(GGUF_MAGIC + struct.pack("<IQQ", 3, 0, len(meta)))
        for key, value in meta.items():
            vtype, payload = _typed(value)
            fh.write(_string(key) + struct.pack("<I", vtype) + payload)


def tokenizer_json(vocab: dict[str, int], merges: list) -> dict:
    """The ``tokenizer.json`` of a byte-level BPE of ``vocab`` and
    ``merges`` (pairs), field for field as ``tokenizers`` writes it."""
    level = {"add_prefix_space": False, "trim_offsets": True,
             "use_regex": True}
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [], "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", **level},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", **level,
                        "add_prefix_space": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": [list(m) for m in merges]}}


def tokenizer_from_gguf(path: str):
    """Build the port's Tokenizer from a GGUF checkpoint's embedded
    vocabulary (gpt2-style byte-level BPE)."""
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    meta = read_metadata(path)
    model = meta.get("tokenizer.ggml.model")
    tokens = meta.get("tokenizer.ggml.tokens")
    if tokens is None:
        raise ValueError(f"{path} has no tokenizer.ggml.tokens metadata")
    if model != "gpt2":
        raise ValueError(
            f"GGUF tokenizer model {model!r} unsupported (gpt2-style "
            f"byte-level BPE only; sentencepiece GGUFs should ship a "
            f"tokenizer.json instead)")
    merges_raw = meta.get("tokenizer.ggml.merges") or []
    vocab = {tok: i for i, tok in enumerate(tokens)}
    merges = [tuple(m.split(" ", 1)) for m in merges_raw if " " in m]
    blob = json.dumps(tokenizer_json(vocab, merges), ensure_ascii=False,
                      separators=(",", ":")).encode("utf-8")
    tok = Tokenizer.from_bytes(blob)
    eos = meta.get("tokenizer.ggml.eos_token_id")
    if eos is not None:
        tok.eos_override = [int(eos)]
    return tok
