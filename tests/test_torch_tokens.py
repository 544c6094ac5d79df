"""The port's token-block hashes are the JAX package's, bit for bit.

``dynamo_tpu_torch/llm/xxh3.py`` is a pure-Python XXH3-64 (the card's
machine has no ``xxhash``); it must equal ``xxhash.xxh3_64`` with the
block-hash seed at every length class (0-16, 17-128, 129-240 bytes and the
long path with its seed-derived secret), and the block hashes built on it
must equal ``dynamo_tpu.llm.tokens``'s, so the port's prefix cache, its
future KV events and the frontend's KV router agree. ``xxhash`` and the
reference module are imported inside the tests.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu_torch.llm import tokens as ttok
from dynamo_tpu_torch.llm.xxh3 import xxh3_64


@pytest.mark.parametrize("seed", [1337, 0, 2**64 - 1])
def test_xxh3_every_length_0_to_1024(seed):
    import xxhash
    rng = np.random.default_rng(seed % 997)
    for n in range(1025):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert xxh3_64(data, seed) == \
            xxhash.xxh3_64(data, seed=seed).intdigest(), n


@settings(max_examples=200, deadline=None)
@given(data=st.binary(min_size=0, max_size=3000))
def test_xxh3_random_contents(data):
    import xxhash
    assert xxh3_64(data, ttok.HASH_SEED) == \
        xxhash.xxh3_64(data, seed=ttok.HASH_SEED).intdigest()


@pytest.mark.parametrize("page", [16, 32, 64])
def test_block_hashes_match_reference(page):
    from dynamo_tpu.llm import tokens as jtok
    rng = np.random.default_rng(page)
    ids = rng.integers(0, 2**32, 5 * page + 7, dtype=np.uint64).tolist()
    assert ttok.HASH_SEED == jtok.HASH_SEED
    assert ttok.hash_block(None, ids[:page]) == \
        jtok.hash_block(None, ids[:page])
    assert ttok.hash_block(12345, ids[:page]) == \
        jtok.hash_block(12345, ids[:page])
    salt = ttok.chain_salt("adapter-a")
    assert salt == jtok.chain_salt("adapter-a")
    assert ttok.chain_salt(None) is jtok.chain_salt(None) is None
    for s in (None, salt):
        assert ttok.compute_block_hashes(ids, page, s) == \
            jtok.compute_block_hashes(ids, page, s)
    # Incremental: extend in uneven pieces, then append one at a time.
    port = ttok.TokenBlockSequence(page, ids[:page + 3], salt=salt)
    ref = jtok.TokenBlockSequence(page, ids[:page + 3], salt=salt)
    assert port.extend(ids[page + 3:3 * page]) == \
        ref.extend(ids[page + 3:3 * page])
    for t in ids[3 * page:]:
        assert port.append(t) == ref.append(t)
    assert port.block_hashes == ref.block_hashes
    assert port.num_complete_blocks == ref.num_complete_blocks == 5
    assert len(port) == len(ref)
