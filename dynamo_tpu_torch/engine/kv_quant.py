"""Paged KV pool reads and writes, bf16 or int8 (counterpart of the device
side of ``dynamo_tpu.engine.kv_quant``).

The pool keeps the reference layout ``[L, Nkv, P, page, D]``. With
``--quant-kv int8`` each of K and V is a ``QuantKV``: int8 values plus one
float32 absmax scale per (layer, kv-head, page, token), so a page can fill
across several decode windows without reading it back. Every write
quantizes (the prefill page scatter and the decode-window commit); every
read dequantizes (the paged attention kernel in registers, the plain
gather here). Writes happen in place: torch tensors are mutable, so the
pool is never copied.

Host parcels (the disaggregation wire, ``llm/kv_transfer.py`` and
``llm/kv_plane.py``) are numpy arrays in the reference's layouts: bf16
``[2, L, Nkv, n, page, D]`` or the packed int8 form ``[2, L, Nkv, n, page,
D + 4]`` uint8, whose last four lanes are each row's f32 scale bytes
(``pack_parcel``/``unpack_parcel``). numpy has no bfloat16 without
``ml_dtypes``, so a bf16 parcel is held as its uint16 bits (``BF16``); its
wire dtype is still ``"bfloat16"`` (``parcel_dtype_name``) and its bytes
are the reference's. No parcel is genuinely uint16.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# f32 scale bytes per (layer, kv-head, token) beside head_dim int8 values.
KV_SCALE_BYTES = 4
# numpy dtype of a bf16 host parcel: the values' bits.
BF16 = np.dtype(np.uint16)


class QuantKV(NamedTuple):
    """int8 paged KV pool + per-token-per-head scales.

    data  int8    [L, Nkv, P, page, D]
    scale float32 [L, Nkv, P, page]
    """
    data: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        # The logical (value) shape: call sites read page and head dims
        # off ``cache.shape`` exactly as for a bf16 pool.
        return self.data.shape

    @property
    def dtype(self) -> torch.dtype:
        # The VALUE dtype: buffers that hold unquantized K/V (window
        # buffers, the self column) allocate with ``cache.dtype``.
        return torch.bfloat16

    @property
    def nbytes(self) -> int:
        return self.data.nbytes + self.scale.nbytes


def is_quantized(cache) -> bool:
    return isinstance(cache, QuantKV)


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token absmax int8 over the last (head_dim) axis.
    x [..., D] -> (q int8 [..., D], s float32 [...]). All-zero rows get
    s = 1. fp32 throughout, a true division and round-half-to-even, so the
    codes are bit-identical to the reference's ``quantize_np``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # A tensor divisor: on CUDA, torch divides by a Python scalar as a
    # multiply by its reciprocal, which can differ from amax / 127 by an ulp.
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def kv_dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(int8 [..., D], f32 [...]) -> bf16 [..., D]."""
    return (q.float() * s[..., None]).to(torch.bfloat16)


def gather_pages_folded(cache, layer: int,
                        page_table: torch.Tensor) -> torch.Tensor:
    """History gather ``[Nkv, B, maxP*page, D]`` (bf16) for one layer: the
    attention dot's K/V operand layout, dequantizing an int8 pool.
    ``cache[layer]`` is a view, so only the gathered pages are read."""
    b, maxp = page_table.shape
    nkv, page, d = cache.shape[1], cache.shape[3], cache.shape[4]
    pt = page_table.long()
    if isinstance(cache, QuantKV):
        out = kv_dequantize(cache.data[layer][:, pt],
                            cache.scale[layer][:, pt])
    else:
        out = cache[layer][:, pt]                 # [Nkv, B, maxP, page, D]
    return out.reshape(nkv, b, maxp * page, d)


def scatter_pages(cache, blocks: torch.Tensor, flat_pages: torch.Tensor):
    """Whole-page commit ``cache[:, :, flat_pages] = blocks`` in place,
    quantizing for an int8 pool. blocks [L, Nkv, n, page, D]."""
    idx = flat_pages.long()
    if isinstance(cache, QuantKV):
        q, s = kv_quantize(blocks)
        cache.data[:, :, idx] = q
        cache.scale[:, :, idx] = s
    else:
        cache[:, :, idx] = blocks.to(cache.dtype)
    return cache


def scatter_tokens(cache, vals: torch.Tensor, dest: torch.Tensor,
                   off: torch.Tensor):
    """Per-token commit ``cache[:, :, dest, off] = vals`` in place (the
    decode-window commit), quantizing for an int8 pool.
    vals [L, Nkv, *dest.shape, D]."""
    dest, off = dest.long(), off.long()
    if isinstance(cache, QuantKV):
        q, s = kv_quantize(vals)
        cache.data[:, :, dest, off] = q
        cache.scale[:, :, dest, off] = s
    else:
        cache[:, :, dest, off] = vals.to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# Host-side (numpy) twins and the packed parcel codec
# ---------------------------------------------------------------------------

def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16) -> float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16) \
        .view(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits (uint16), round to nearest even, as
    ``ml_dtypes`` and XLA convert."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def quantize_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of kv_quantize: f32 math, round half to even, so host-
    and device-quantized blocks agree bit for bit. ``x`` is a bf16 parcel
    (uint16 bits) or a float array."""
    xf = bf16_to_f32(x) if x.dtype == BF16 else np.asarray(x, np.float32)
    amax = np.max(np.abs(xf), axis=-1)
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(xf / s[..., None]), -127, 127).astype(np.int8)
    return q, s


def dequantize_np(q: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(int8 [..., D], f32 [...]) -> bf16 bits [..., D]."""
    return f32_to_bf16(q.astype(np.float32)
                       * np.asarray(s, np.float32)[..., None])


def pack_parcel(data: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(int8 [..., page, D], f32 [..., page]) -> uint8 [..., page, D+4]:
    one contiguous array, so every wire path carries the compressed
    form unchanged."""
    d = data.shape[-1]
    out = np.empty((*data.shape[:-1], d + KV_SCALE_BYTES), np.uint8)
    out[..., :d] = data.view(np.uint8)
    out[..., d:] = np.ascontiguousarray(
        np.asarray(scale, np.float32)).view(np.uint8) \
        .reshape(*scale.shape, KV_SCALE_BYTES)
    return out


def unpack_parcel(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 [..., page, D+4] -> (int8 [..., page, D], f32 [..., page])."""
    d = packed.shape[-1] - KV_SCALE_BYTES
    data = np.ascontiguousarray(packed[..., :d]).view(np.int8)
    scale = np.ascontiguousarray(packed[..., d:]).view(np.float32)[..., 0]
    return data, scale


def is_packed_parcel(arr: np.ndarray) -> bool:
    """Parcel form by dtype: uint8 = packed int8 + scales, else raw."""
    return arr.dtype == np.uint8


def parcel_dtype_name(arr: np.ndarray) -> str:
    """The parcel's wire dtype: ``"bfloat16"`` for bf16 bits."""
    return "bfloat16" if arr.dtype == BF16 else str(arr.dtype)


def parcel_dtype(name: str) -> np.dtype:
    """numpy dtype of a parcel whose wire dtype is ``name``."""
    return BF16 if name == "bfloat16" else np.dtype(name)


def parcel_to_bf16(arr: np.ndarray) -> np.ndarray:
    """Any parcel -> bf16 bits: packed parcels dequantize, float ones
    round."""
    if is_packed_parcel(arr):
        return dequantize_np(*unpack_parcel(arr))
    return arr if arr.dtype == BF16 else f32_to_bf16(arr)


def parcel_to_packed(arr: np.ndarray) -> np.ndarray:
    return arr if is_packed_parcel(arr) else pack_parcel(*quantize_np(arr))
