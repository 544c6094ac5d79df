"""The port's msgpack codec (``dynamo_tpu_torch.runtime.msgpack_lite``) and
frame codec (``runtime/frame.py``) against the ``msgpack`` package and the
JAX package's ``dynamo_tpu.runtime.frame``.

- ``packb`` is byte-identical to ``msgpack.packb(use_bin_type=True)`` and
  ``unpackb`` of msgpack's bytes equals ``msgpack.unpackb(raw=False)``:
  over a hypothesis strategy of nested values, a boundary table of ints,
  str, bin, array and map sizes, and float32 input bytes.
- The same exception classes as msgpack for values outside the subset.
- Real frames: the ``LLMEngineOutput`` dicts that ``GPUEngine.generate``
  yields on tiny-test (with logprobs) and a ``ModelEntry.to_wire()``.
- ``write_frame``/``read_frame`` over a socket pair give the bytes of the
  JAX ``encode_frame`` and refuse a frame over ``MAX_FRAME``.
"""

import asyncio
import math
import socket
import struct

import msgpack
import numpy as np
import pytest
import torch
from conftest import async_test
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import frame as jframe
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.runtime import frame as tframe
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.msgpack_lite import packb, unpackb

torch.set_num_threads(1)


def ref_packb(obj):
    return msgpack.packb(obj, use_bin_type=True)


def ref_unpackb(data):
    return msgpack.unpackb(data, raw=False)


def same(a, b) -> bool:
    """Equal values of equal types; nan equals nan, -0.0 differs from 0.0."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1, a) == math.copysign(1, b))
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    return a == b


def check(obj) -> None:
    want = ref_packb(obj)
    assert packb(obj) == want
    assert same(unpackb(want), ref_unpackb(want))


_SCALARS = (st.none() | st.booleans()
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=True, allow_infinity=True)
            | st.sampled_from([-0.0, 0.0, math.nan, math.inf, -math.inf])
            | st.text() | st.binary())
_VALUES = st.recursive(
    _SCALARS,
    lambda children: (st.lists(children, max_size=20)
                      | st.lists(children, max_size=20).map(tuple)
                      | st.dictionaries(st.text(max_size=12), children,
                                        max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(obj=_VALUES)
def test_hypothesis_values(obj):
    check(obj)


_INT_EDGES = [2**5, 2**7, 2**8, 2**15, 2**16, 2**31, 2**32]
INTS = sorted({v + d for e in _INT_EDGES for v in (e, -e) for d in (-1, 0, 1)}
              | {-2**63, -2**63 + 1, 2**63 - 2, 2**63 - 1, 2**63,
                 2**64 - 2, 2**64 - 1, 0})


@pytest.mark.parametrize("n", INTS)
def test_int_boundaries(n):
    check(n)


@pytest.mark.parametrize("length", [0, 31, 32, 255, 256, 65535, 65536])
def test_str_lengths(length):
    check("é" * (length // 2) + "x" * (length % 2))
    check("x" * length)


@pytest.mark.parametrize("length", [0, 255, 256, 65535, 65536])
def test_bin_lengths(length):
    check(bytes(range(256)) * (length // 256) + b"\x07" * (length % 256))
    check(bytearray(b"\x01" * length))
    assert packb(memoryview(b"\x02" * length)) == ref_packb(
        memoryview(b"\x02" * length))


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_array_and_map_sizes(n):
    check(list(range(n)))
    check(tuple(range(n)))
    check({f"k{i}": i for i in range(n)})


@pytest.mark.parametrize("value", [0.0, 1.5, -3.25, 1e-40, 3.4e38, math.inf,
                                   -math.inf])
def test_float32_input(value):
    data = b"\xca" + struct.pack(">f", value)
    assert same(unpackb(data), ref_unpackb(data))


def test_float32_nan_input():
    data = b"\xca" + struct.pack(">f", math.nan)
    assert math.isnan(unpackb(data)) and math.isnan(ref_unpackb(data))


@pytest.mark.parametrize("bad", [2**64, -2**63 - 1, {1, 2}, np.int64(3),
                                 np.float32(1.5), np.bool_(True),
                                 {"nested": [np.int32(1)]}],
                         ids=["2^64", "-2^63-1", "set", "np.int64",
                              "np.float32", "np.bool_", "nested np.int32"])
def test_same_exception_classes(bad):
    with pytest.raises(Exception) as ref:
        ref_packb(bad)
    with pytest.raises(Exception) as port:
        packb(bad)
    assert type(port.value) is type(ref.value)


def test_numpy_float64_packs_as_float():
    for v in (np.float64(2.5), {"lp": [np.float64(-0.125)]}):
        check(v)


def test_malformed_input_raises_value_error():
    good = ref_packb({"a": [1, 2, "x"]})
    for data in (good[:-1], good + b"\x00", b"\xc1", b"\xd9",
                 ref_packb({1: 2}), b"\xd4\x01\x00"):
        with pytest.raises(ValueError):
            unpackb(data)


@async_test(timeout=120)
async def test_engine_output_frames_match():
    spec = tcfg.PRESETS["tiny-test"]
    engine = GPUEngine(tcfg.EngineConfig(
        model=spec, device="cpu", page_size=16, num_pages=64,
        max_pages_per_seq=16, max_num_seqs=4, decode_window=4,
        pipeline_depth=2), seed=3)
    try:
        outs = []
        req = {"model": "tiny-test", "token_ids": list(range(5, 30)),
               "stop_conditions": {"max_tokens": 9, "ignore_eos": True},
               "sampling_options": {"logprobs": 3}}
        async for item in engine.generate(req, Context()):
            outs.append(item)
    finally:
        engine.stop()
    assert outs and outs[-1]["finish_reason"] == "length"
    assert any(o.get("top_log_probs") for o in outs)
    for seq, item in enumerate(outs):
        frame = {"t": "data", "rid": "r" * 32, "p": item, "s": seq}
        check(frame)
        assert tframe.encode_frame(frame) == jframe.encode_frame(frame)


def test_model_entry_frame_matches():
    card = tcard.ModelDeploymentCard(
        name="tiny-test", tokenizer_key="tokenizers/tiny-test-0123456789ab",
        context_length=4096, migration_limit=2,
        runtime_config=tcard.ModelRuntimeConfig(
            total_kv_blocks=64, max_num_seqs=4, extra={"hidden_size": 128}))
    entry = tcard.ModelEntry(model_name="tiny-test", namespace="dynamo",
                             component="gpu", endpoint="generate",
                             model_type="chat", card=card)
    check(entry.to_wire())
    assert tcard.ModelEntry.from_wire(unpackb(packb(entry.to_wire()))) == entry


@async_test(timeout=60)
async def test_frames_over_a_socket_pair():
    frames = [{"t": "req", "rid": "abc", "p": {"token_ids": [1, 2, 3]},
               "ctx": Context().to_wire()},
              {"i": 7, "ok": True, "r": [{"k": "a", "v": b"\x00\xff",
                                           "rev": 2**40}]},
              {"t": "final", "rid": "abc", "s": 0}]
    a, b = socket.socketpair()
    reader, writer = await asyncio.open_connection(sock=a)
    peer_reader, peer_writer = await asyncio.open_connection(sock=b)
    try:
        for f in frames:
            await tframe.write_frame(writer, f)
        raw = await asyncio.wait_for(peer_reader.readexactly(
            sum(len(jframe.encode_frame(f)) for f in frames)), 10)
        assert raw == b"".join(jframe.encode_frame(f) for f in frames)
        # Read back what the JAX package writes.
        for f in frames:
            peer_writer.write(jframe.encode_frame(f))
        await peer_writer.drain()
        for f in frames:
            assert same(await asyncio.wait_for(tframe.read_frame(reader), 10),
                        ref_unpackb(jframe.encode_frame(f)[4:]))
        # A header over MAX_FRAME is refused before its body is read.
        peer_writer.write(struct.pack(">I", tframe.MAX_FRAME + 1))
        await peer_writer.drain()
        with pytest.raises(ValueError, match="frame too large"):
            await asyncio.wait_for(tframe.read_frame(reader), 10)
        # A clean EOF is IncompleteReadError, as in the reference.
        peer_writer.close()
        with pytest.raises(asyncio.IncompleteReadError):
            await asyncio.wait_for(tframe.read_frame(reader), 10)
    finally:
        writer.close()
        peer_writer.close()


def test_encode_refuses_over_max_frame(monkeypatch):
    monkeypatch.setattr(tframe, "MAX_FRAME", 64)
    assert len(tframe.encode_frame({"p": b"x" * 50})) == 4 + 55
    with pytest.raises(ValueError, match="frame too large"):
        tframe.encode_frame({"p": b"x" * 64})
