"""XXH3-64 with a seed, in pure Python (the ``xxhash`` package's
``xxh3_64(data, seed=...).intdigest()``, which the JAX package's block
hashes use and the card's machine does not have).

Every length class of the reference implementation (xxhash 0.8, XXH3 64-bit
variant) is here: 0, 1-3, 4-8, 9-16, 17-128 and 129-240 bytes, and the long
path above 240 bytes with its seed-derived secret. A page-16 token block
(8 bytes of parent hash + 64 bytes of ids) takes the 17-128 path, page 32 the
129-240 path and page 64 the long one. All arithmetic is on Python ints
masked to 64 bits; the secret is read into ints once, at import.
"""

from __future__ import annotations

import struct

M64 = (1 << 64) - 1

PRIME32_1 = 0x9E3779B1
PRIME32_2 = 0x85EBCA77
PRIME32_3 = 0xC2B2AE3D
PRIME64_1 = 0x9E3779B185EBCA87
PRIME64_2 = 0xC2B2AE3D27D4EB4F
PRIME64_3 = 0x165667B19E3779F9
PRIME64_4 = 0x85EBCA77C2B2AE63
PRIME64_5 = 0x27D4EB2F165667C5
PRIME_MX1 = 0x165667919E3779F9
PRIME_MX2 = 0x9FB21C651E98DF25

# The reference's default 192-byte secret (kSecret).
SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
SECRET_SIZE = len(SECRET)
STRIPE_LEN = 64
STRIPES_PER_BLOCK = (SECRET_SIZE - STRIPE_LEN) // 8
BLOCK_LEN = STRIPE_LEN * STRIPES_PER_BLOCK

_u32 = struct.Struct("<I").unpack_from
_u64 = struct.Struct("<Q").unpack_from
_u64x2 = struct.Struct("<2Q").unpack_from
_u64x8 = struct.Struct("<8Q").unpack_from


def _word(offset: int) -> int:
    return _u64(SECRET, offset)[0]


# Secret words at every byte offset the short paths read.
_SW = [_word(i) for i in range(SECRET_SIZE - 7)]


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * PRIME_MX1) & M64
    return h ^ (h >> 32)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * PRIME64_2) & M64
    h ^= h >> 29
    h = (h * PRIME64_3) & M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, length: int) -> int:
    h ^= (((h << 49) | (h >> 15)) ^ ((h << 24) | (h >> 40))) & M64
    h = (h * PRIME_MX2) & M64
    h ^= (h >> 35) + length
    h = (h * PRIME_MX2) & M64
    return h ^ (h >> 28)


def _fold(a: int, b: int) -> int:
    """128-bit product of two u64, low half xor high half."""
    p = a * b
    return (p ^ (p >> 64)) & M64


def _mix16(data: bytes, off: int, s: int, seed: int) -> int:
    lo, hi = _u64x2(data, off)
    return _fold(lo ^ ((_SW[s] + seed) & M64), hi ^ ((_SW[s + 8] - seed) & M64))


def _len_0to16(data: bytes, n: int, seed: int) -> int:
    if n > 8:
        flip1 = ((_SW[24] ^ _SW[32]) + seed) & M64
        flip2 = ((_SW[40] ^ _SW[48]) - seed) & M64
        lo = _u64(data, 0)[0] ^ flip1
        hi = _u64(data, n - 8)[0] ^ flip2
        acc = (n + int.from_bytes(lo.to_bytes(8, "little"), "big") + hi
               + _fold(lo, hi)) & M64
        return _avalanche(acc)
    if n >= 4:
        s32 = seed & 0xFFFFFFFF
        seed ^= int.from_bytes(s32.to_bytes(4, "little"), "big") << 32
        in1 = _u32(data, 0)[0]
        in2 = _u32(data, n - 4)[0]
        flip = ((_SW[8] ^ _SW[16]) - seed) & M64
        return _rrmxmx((in2 + (in1 << 32)) ^ flip, n)
    if n:
        combined = ((data[0] << 16) | (data[n >> 1] << 24) | data[n - 1]
                    | (n << 8))
        flip = ((_u32(SECRET, 0)[0] ^ _u32(SECRET, 4)[0]) + seed) & M64
        return _xxh64_avalanche(combined ^ flip)
    return _xxh64_avalanche(seed ^ _SW[56] ^ _SW[64])


def _len_17to128(data: bytes, n: int, seed: int) -> int:
    acc = (n * PRIME64_1) & M64
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16(data, 48, 96, seed)
                acc += _mix16(data, n - 64, 112, seed)
            acc += _mix16(data, 32, 64, seed)
            acc += _mix16(data, n - 48, 80, seed)
        acc += _mix16(data, 16, 32, seed)
        acc += _mix16(data, n - 32, 48, seed)
    acc += _mix16(data, 0, 0, seed)
    acc += _mix16(data, n - 16, 16, seed)
    return _avalanche(acc & M64)


def _len_129to240(data: bytes, n: int, seed: int) -> int:
    acc = (n * PRIME64_1) & M64
    for i in range(8):
        acc += _mix16(data, 16 * i, 16 * i, seed)
    acc = _avalanche(acc & M64)
    for i in range(8, n // 16):
        acc += _mix16(data, 16 * i, 16 * (i - 8) + 3, seed)
    acc += _mix16(data, n - 16, 136 - 17, seed)
    return _avalanche(acc & M64)


def _accumulate_512(acc: list[int], data: bytes, off: int,
                    key: tuple) -> None:
    vals = _u64x8(data, off)
    for i in range(8):
        v = vals[i]
        k = v ^ key[i]
        acc[i ^ 1] = (acc[i ^ 1] + v) & M64
        acc[i] = (acc[i] + (k & 0xFFFFFFFF) * (k >> 32)) & M64


def _len_long(data: bytes, n: int, seed: int) -> int:
    secret = b"".join(
        struct.pack("<2Q", (_SW[i] + seed) & M64, (_SW[i + 8] - seed) & M64)
        for i in range(0, SECRET_SIZE, 16))
    # Key words for stripe s (secret offset 8 s), the scramble and the
    # last stripe.
    keys = [_u64x8(secret, 8 * s) for s in range(STRIPES_PER_BLOCK)]
    scramble = _u64x8(secret, SECRET_SIZE - STRIPE_LEN)
    last_key = _u64x8(secret, SECRET_SIZE - STRIPE_LEN - 7)
    acc = [PRIME32_3, PRIME64_1, PRIME64_2, PRIME64_3, PRIME64_4, PRIME32_2,
           PRIME64_5, PRIME32_1]
    n_blocks = (n - 1) // BLOCK_LEN
    for blk in range(n_blocks):
        base = blk * BLOCK_LEN
        for s in range(STRIPES_PER_BLOCK):
            _accumulate_512(acc, data, base + s * STRIPE_LEN, keys[s])
        for i in range(8):
            a = acc[i]
            a ^= a >> 47
            acc[i] = ((a ^ scramble[i]) * PRIME32_1) & M64
    base = n_blocks * BLOCK_LEN
    for s in range(((n - 1) - base) // STRIPE_LEN):
        _accumulate_512(acc, data, base + s * STRIPE_LEN, keys[s])
    _accumulate_512(acc, data, n - STRIPE_LEN, last_key)
    result = (n * PRIME64_1) & M64
    merge = _u64x8(secret, 11)
    for i in range(4):
        result += _fold(acc[2 * i] ^ merge[2 * i],
                        acc[2 * i + 1] ^ merge[2 * i + 1])
    return _avalanche(result & M64)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3 64-bit hash of ``data`` with ``seed``, as an unsigned int."""
    n = len(data)
    seed &= M64
    if n <= 16:
        return _len_0to16(data, n, seed)
    if n <= 128:
        return _len_17to128(data, n, seed)
    if n <= 240:
        return _len_129to240(data, n, seed)
    return _len_long(data, n, seed)
