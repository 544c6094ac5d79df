"""Token-block hashing (copy of ``dynamo_tpu.llm.tokens``).

Token sequences split into fixed-size blocks; each block's hash chains its
parent's (XXH3-64 with seed ``HASH_SEED`` over the parent hash, 8 bytes
little-endian, 0 for the root, then the ids as u32 little-endian), so a
block hash names the whole prefix up to and including that block. The
engine's prefix cache, KV events and the frontend's KV router must agree on
these hashes bit for bit; ``llm/xxh3.py`` computes the same XXH3 as the
``xxhash`` package the JAX package uses.
"""

from __future__ import annotations

import struct
from typing import Iterable, Sequence

from dynamo_tpu_torch.llm.xxh3 import xxh3_64

# Fixed seed so every process chains the same hashes.
HASH_SEED = 1337


def hash_block(parent_hash: int | None, token_ids: Sequence[int]) -> int:
    """xxh3_64 over the parent hash (0 for the root) and the token ids."""
    data = struct.pack(f"<Q{len(token_ids)}I",
                       parent_hash if parent_hash is not None else 0,
                       *token_ids)
    return xxh3_64(data, HASH_SEED)


def chain_salt(name: str | None) -> int | None:
    """Root-of-chain salt for content that conditions KV beyond the token
    ids, such as a LoRA adapter name, so its block hashes never alias the
    base model's. None -> the unsalted base chain."""
    if not name:
        return None
    return xxh3_64(name.encode(), HASH_SEED)


def compute_block_hashes(token_ids: Sequence[int], block_size: int,
                         salt: int | None = None) -> list[int]:
    """Hashes of every COMPLETE block of the sequence (a partial tail block
    cannot be shared). ``salt`` (chain_salt) roots the chain."""
    hashes: list[int] = []
    parent: int | None = salt
    for start in range(0, len(token_ids) - block_size + 1, block_size):
        parent = hash_block(parent, token_ids[start:start + block_size])
        hashes.append(parent)
    return hashes


class TokenBlockSequence:
    """A token sequence kept as hashed complete blocks plus a partial
    tail."""

    def __init__(self, block_size: int, token_ids: Iterable[int] = (),
                 salt: int | None = None):
        self.block_size = block_size
        self.tokens: list[int] = []
        self.block_hashes: list[int] = []
        self.salt = salt
        self.extend(token_ids)

    def extend(self, token_ids: Iterable[int]) -> list[int]:
        """Append tokens; return the hashes of newly completed blocks."""
        self.tokens.extend(token_ids)
        new: list[int] = []
        while len(self.tokens) // self.block_size > len(self.block_hashes):
            idx = len(self.block_hashes)
            block = self.tokens[idx * self.block_size:
                                (idx + 1) * self.block_size]
            parent = self.block_hashes[-1] if self.block_hashes else self.salt
            h = hash_block(parent, block)
            self.block_hashes.append(h)
            new.append(h)
        return new

    def append(self, token_id: int) -> int | None:
        new = self.extend([token_id])
        return new[0] if new else None

    @property
    def num_complete_blocks(self) -> int:
        return len(self.block_hashes)

    def __len__(self) -> int:
        return len(self.tokens)
