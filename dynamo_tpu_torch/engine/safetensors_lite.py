"""The safetensors file format, read and written on numpy and torch (the
port's counterpart of the ``safetensors`` package, which the GPU machine
does not have).

A file is an 8-byte little-endian header length N, N bytes of JSON (padded
with spaces; an optional ``__metadata__`` object of strings), then the raw
little-endian tensor bytes. Each header entry names a tensor's ``dtype``,
``shape`` and ``data_offsets`` ``[begin, end)``, counted from the end of
the header.

``SafeOpen`` maps a file copy-on-write and hands out each tensor as a view
of the mapping: nothing is read twice into host memory, and a tensor's
pages come from the page cache as the caller copies them where they go
(the weight loader: into a preallocated device tensor). The mapping stays
open while any such view lives (closing it then raises ``BufferError``).
``save_file`` writes such files.

Dtypes: BF16, F16, F32 and the integer ones (I8, U8, I16, I32, I64,
BOOL). Any other (F64, the F8_* kinds, ...) raises ``ValueError`` naming
it.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the raw bytes, torch dtype). BF16
# has no numpy dtype: its bytes are read as uint16 and viewed as bf16.
DTYPES = {
    "BF16": (np.uint16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "I16": (np.int16, torch.int16),
    "I32": (np.int32, torch.int32),
    "I64": (np.int64, torch.int64),
    "BOOL": (np.bool_, torch.bool),
}
NAME_OF = {t: name for name, (_, t) in DTYPES.items()}
# The safetensors library refuses headers larger than this.
MAX_HEADER_BYTES = 100_000_000


class SafeOpen:
    """One safetensors file, mapped: ``keys()``, ``metadata()``,
    ``shape_of(name)`` and ``get_tensor(name)`` (a view of the mapping, on
    the CPU). A context manager; ``close()`` unmaps."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as fh:
            head = fh.read(8)
            if len(head) < 8:
                raise ValueError(f"{self.path}: truncated safetensors file "
                                 f"({size} bytes, no header length)")
            (n,) = struct.unpack("<Q", head)
            if n > MAX_HEADER_BYTES or 8 + n > size:
                raise ValueError(f"{self.path}: truncated or invalid "
                                 f"safetensors header (length {n}, file "
                                 f"{size} bytes)")
            raw = fh.read(n)
            try:
                header = json.loads(raw)
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise ValueError(f"{self.path}: the safetensors header is "
                                 f"not JSON ({exc})") from None
            self._base = 8 + n
            data_bytes = size - self._base
            self._meta = header.pop("__metadata__", None) or {}
            self._entries = {}
            for name, entry in header.items():
                self._entries[name] = self._check(name, entry, data_bytes)
            # An empty data section cannot be mapped; tensors are then all
            # empty and need no mapping.
            self._mm = (mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
                        if data_bytes else None)

    def _check(self, name: str, entry: dict, data_bytes: int):
        dtype = entry.get("dtype")
        if dtype not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{dtype!r}, which the port does not read "
                             f"(supported: {', '.join(DTYPES)})")
        shape = tuple(int(x) for x in entry["shape"])
        begin, end = (int(x) for x in entry["data_offsets"])
        np_dtype = DTYPES[dtype][0]
        want = math.prod(shape) * np.dtype(np_dtype).itemsize
        if not 0 <= begin <= end <= data_bytes or end - begin != want:
            raise ValueError(f"{self.path}: tensor {name!r} ({dtype}, "
                             f"{list(shape)}) has data_offsets "
                             f"[{begin}, {end}) for {want} bytes in a "
                             f"{data_bytes}-byte data section (truncated?)")
        return dtype, shape, begin

    def keys(self) -> list[str]:
        return list(self._entries)

    def metadata(self) -> dict:
        return dict(self._meta)

    def shape_of(self, name: str) -> tuple:
        return self._entries[name][1]

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor as a CPU view of the mapped file (no copy)."""
        try:
            dtype, shape, begin = self._entries[name]
        except KeyError:
            raise KeyError(f"{self.path} has no tensor {name!r}") from None
        np_dtype, torch_dtype = DTYPES[dtype]
        count = math.prod(shape)
        if count == 0:
            return torch.empty(shape, dtype=torch_dtype)
        arr = np.frombuffer(self._mm, dtype=np_dtype, count=count,
                            offset=self._base + begin)
        t = torch.from_numpy(arr.reshape(shape))
        return t.view(torch.bfloat16) if dtype == "BF16" else t

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def __enter__(self) -> "SafeOpen":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.close()
        except BufferError:
            # A view still lives: while an exception unwinds, its traceback
            # may hold one, and the mapping goes with the last view; the
            # exception in flight is the one to report.
            if exc_type is None:
                raise


def save_file(tensors: dict[str, torch.Tensor], path: str | os.PathLike,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (any device; each copied to the host one at a time)
    as one safetensors file, in the given order."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in NAME_OF:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors name the port writes")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": NAME_OF[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for t in tensors.values():
            host = t.detach().contiguous().cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            fh.write(host.numpy().reshape(-1).view(np.uint8).data)
