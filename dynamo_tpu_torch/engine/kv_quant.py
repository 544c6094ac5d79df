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

The numpy parcel codec (``pack_parcel``/``unpack_parcel``) arrives with the
KV plane, which is its only user.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# f32 scale bytes per (layer, kv-head, token) beside head_dim int8 values.
KV_SCALE_BYTES = 4


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
