"""Paged KV pool reads and writes, bf16 subset of ``dynamo_tpu.engine.kv_quant``.

The pool keeps the reference layout ``[L, Nkv, P, page, D]``. The int8
pool (``QuantKV``, per-token scales) is a later slice; these functions take
plain bf16 tensors. Writes happen in place: torch tensors are mutable, so
the pool is never copied.
"""

from __future__ import annotations

import torch


def gather_pages_folded(cache: torch.Tensor, layer: int,
                        page_table: torch.Tensor) -> torch.Tensor:
    """History gather ``[Nkv, B, maxP*page, D]`` for one layer: the
    attention dot's K/V operand layout. ``cache[layer]`` is a view, so only
    the gathered pages are read."""
    b, maxp = page_table.shape
    nkv, page, d = cache.shape[1], cache.shape[3], cache.shape[4]
    out = cache[layer][:, page_table.long()]          # [Nkv, B, maxP, page, D]
    return out.reshape(nkv, b, maxp * page, d)


def scatter_pages(cache: torch.Tensor, blocks: torch.Tensor,
                  flat_pages: torch.Tensor) -> torch.Tensor:
    """Whole-page commit ``cache[:, :, flat_pages] = blocks`` in place.
    blocks [L, Nkv, n, page, D]."""
    cache[:, :, flat_pages.long()] = blocks.to(cache.dtype)
    return cache


def scatter_tokens(cache: torch.Tensor, vals: torch.Tensor,
                   dest: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Per-token commit ``cache[:, :, dest, off] = vals`` in place (the
    decode-window commit). vals [L, Nkv, *dest.shape, D]."""
    cache[:, :, dest.long(), off.long()] = vals.to(cache.dtype)
    return cache
