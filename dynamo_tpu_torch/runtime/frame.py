"""Length-prefixed msgpack framing over asyncio streams (the wire of
``dynamo_tpu.runtime.frame``, on the port's own codec).

A frame is a 4-byte big-endian length followed by a msgpack map. It is the
codec of the control plane (coordinator) and of the request plane; the
bytes are the JAX package's, so either package's peer reads them.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any

from dynamo_tpu_torch.runtime.msgpack_lite import pack_into, unpackb

MAX_FRAME = 256 * 1024 * 1024  # 256 MiB hard cap
_LEN = struct.Struct(">I")


def _encode(obj: Any) -> bytearray:
    buf = bytearray(_LEN.size)
    pack_into(obj, buf)
    length = len(buf) - _LEN.size
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    _LEN.pack_into(buf, 0, length)
    return buf


def encode_frame(obj: Any) -> bytes:
    return bytes(_encode(obj))


async def read_frame(reader: asyncio.StreamReader) -> Any:
    """Read one frame; raises asyncio.IncompleteReadError on clean EOF."""
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return unpackb(await reader.readexactly(length))


async def write_frame(writer: asyncio.StreamWriter, obj: Any) -> None:
    writer.write(_encode(obj))
    await writer.drain()
