"""The subset of MessagePack that the port's frames carry, in pure Python.

``packb(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
and ``unpackb(data)`` the value of ``msgpack.unpackb(data, raw=False)``
for nil, bool, int (every width up to 64 bits), float (float64 out;
float32 and float64 in), str, bin, array and map, so a frame of the port
is a frame of the JAX package and back. Encoding picks the smallest form,
as msgpack does; tuples pack as arrays, and ``bytearray`` and
``memoryview`` as bin. Where msgpack raises, so does this: ``OverflowError``
for an int outside [-2**63, 2**64), ``TypeError`` for a type outside the
subset (sets, numpy scalars other than ``np.float64``, which is a
``float``), ``ValueError`` for malformed, truncated or trailing input, a
non-str/bytes map key, or an ext type.

The module is named so that it never shadows the ``msgpack`` package.
"""

from __future__ import annotations

import struct
from typing import Any

_U8 = struct.Struct(">BB")
_U16 = struct.Struct(">BH")
_U32 = struct.Struct(">BI")
_U64 = struct.Struct(">BQ")
_I8 = struct.Struct(">Bb")
_I16 = struct.Struct(">Bh")
_I32 = struct.Struct(">Bi")
_I64 = struct.Struct(">Bq")
_F64 = struct.Struct(">Bd")


def _pack_int(n: int, buf: bytearray) -> None:
    if 0 <= n < 0x80:
        buf.append(n)
    elif -0x20 <= n < 0:
        buf.append(n & 0xFF)
    elif n > 0:
        if n <= 0xFF:
            buf += _U8.pack(0xCC, n)
        elif n <= 0xFFFF:
            buf += _U16.pack(0xCD, n)
        elif n <= 0xFFFFFFFF:
            buf += _U32.pack(0xCE, n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            buf += _U64.pack(0xCF, n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -0x80:
        buf += _I8.pack(0xD0, n)
    elif n >= -0x8000:
        buf += _I16.pack(0xD1, n)
    elif n >= -0x80000000:
        buf += _I32.pack(0xD2, n)
    elif n >= -0x8000000000000000:
        buf += _I64.pack(0xD3, n)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, buf: bytearray, fix: int | None, fix_max: int,
              c8: int | None, c16: int, c32: int, what: str) -> None:
    """The header of a str, bin, array or map of ``n`` items: a fix form
    (``fix | n``) up to ``fix_max``, then 8-, 16- and 32-bit lengths."""
    if fix is not None and n <= fix_max:
        buf.append(fix | n)
    elif c8 is not None and n <= 0xFF:
        buf += _U8.pack(c8, n)
    elif n <= 0xFFFF:
        buf += _U16.pack(c16, n)
    elif n <= 0xFFFFFFFF:
        buf += _U32.pack(c32, n)
    else:
        raise ValueError(f"{what} is too large")


def _pack(obj: Any, buf: bytearray) -> None:
    # The order of msgpack's own packer: bool before int (bool is an int),
    # bytes-like before str, dict before list/tuple.
    if obj is None:
        buf.append(0xC0)
    elif obj is True:
        buf.append(0xC3)
    elif obj is False:
        buf.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, buf)
    elif isinstance(obj, float):
        buf += _F64.pack(0xCB, obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), buf, None, 0, 0xC4, 0xC5, 0xC6, "bytes object")
        buf += obj
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), buf, 0xA0, 31, 0xD9, 0xDA, 0xDB,
                  "unicode string")
        buf += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), buf, 0x80, 15, None, 0xDE, 0xDF, "dict")
        for key, value in obj.items():
            _pack(key, buf)
            _pack(value, buf)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), buf, 0x90, 15, None, 0xDC, 0xDD, "list")
        for item in obj:
            _pack(item, buf)
    elif isinstance(obj, memoryview):
        data = obj.tobytes()
        _pack_len(len(data), buf, None, 0, 0xC4, 0xC5, 0xC6, "memoryview")
        buf += data
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def pack_into(obj: Any, buf: bytearray) -> None:
    """Append the MessagePack bytes of ``obj`` to ``buf``."""
    _pack(obj, buf)


def packb(obj: Any) -> bytes:
    buf = bytearray()
    _pack(obj, buf)
    return bytes(buf)


# -- decoding -----------------------------------------------------------------

_INCOMPLETE = "Unpack failed: incomplete input"
# Fixed-width numbers: first byte -> (struct, size).
_NUMBERS = {
    0xCA: (struct.Struct(">f"), 4), 0xCB: (struct.Struct(">d"), 8),
    0xCC: (struct.Struct(">B"), 1), 0xCD: (struct.Struct(">H"), 2),
    0xCE: (struct.Struct(">I"), 4), 0xCF: (struct.Struct(">Q"), 8),
    0xD0: (struct.Struct(">b"), 1), 0xD1: (struct.Struct(">h"), 2),
    0xD2: (struct.Struct(">i"), 4), 0xD3: (struct.Struct(">q"), 8),
}
# Lengths of str/bin/array/map: first byte -> (kind, length struct, size).
_LENGTHS = {
    0xC4: ("bin", _NUMBERS[0xCC]), 0xC5: ("bin", _NUMBERS[0xCD]),
    0xC6: ("bin", _NUMBERS[0xCE]),
    0xD9: ("str", _NUMBERS[0xCC]), 0xDA: ("str", _NUMBERS[0xCD]),
    0xDB: ("str", _NUMBERS[0xCE]),
    0xDC: ("array", _NUMBERS[0xCD]), 0xDD: ("array", _NUMBERS[0xCE]),
    0xDE: ("map", _NUMBERS[0xCD]), 0xDF: ("map", _NUMBERS[0xCE]),
}


def _unpack(data: bytes, i: int) -> tuple[Any, int]:
    """(value, offset after it) of the object at ``data[i:]``."""
    if i >= len(data):
        raise ValueError(_INCOMPLETE)
    b = data[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b == 0xC0:
        return None, i
    elif b == 0xC2:
        return False, i
    elif b == 0xC3:
        return True, i
    elif b in _NUMBERS:
        fmt, size = _NUMBERS[b]
        if i + size > len(data):
            raise ValueError(_INCOMPLETE)
        return fmt.unpack_from(data, i)[0], i + size
    elif b in _LENGTHS:
        kind, (fmt, size) = _LENGTHS[b]
        if i + size > len(data):
            raise ValueError(_INCOMPLETE)
        n = fmt.unpack_from(data, i)[0]
        i += size
    elif b == 0xC1:
        raise ValueError("Unpack failed: error = invalid byte 0xc1")
    else:
        raise ValueError(f"ext type 0x{b:02x} is outside the port's "
                         "msgpack subset")
    if kind in ("str", "bin"):
        if i + n > len(data):
            raise ValueError(_INCOMPLETE)
        raw = data[i:i + n]
        return (raw.decode("utf-8") if kind == "str" else bytes(raw)), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, i = _unpack(data, i)
            items.append(item)
        return items, i
    out = {}
    for _ in range(n):
        key, i = _unpack(data, i)
        if type(key) not in (str, bytes):
            raise ValueError(f"{type(key).__name__} is not allowed for map "
                             "key when strict_map_key=True")
        out[key], i = _unpack(data, i)
    return out, i


def unpackb(data: bytes | bytearray | memoryview) -> Any:
    data = bytes(data)
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"unpack: {len(data) - end} bytes of extra data")
    return obj
