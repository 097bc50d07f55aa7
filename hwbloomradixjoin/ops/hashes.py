"""The reference's 10-function seeded hash library, vectorized.

Bit-exact re-implementations (validated against golden vectors generated from
the reference binary) of the functions in src/hash.c / src/spooky.c:

    crc, FNV, crapwow, Coffin, MurmurOAAT, JenkinsOAAT, Spooky, KR_v2,
    DJB2, x17

Each takes (seed, key) and returns uint32, operating on whole arrays at once
(the reference signature is ``uint32_t f(uint32_t seed, intkey_t key)``,
src/hash.h:10).  They are plain jnp expressions.

The filter-critical functions are ``hash_crapwow`` (probe sequence base,
src/bloom_filter.c:73-76) and ``hash_crc`` (blocked-filter block select,
src/bloom_filter.c:125-127); these must match the reference bit-for-bit for
FPR-table parity.

Byte-at-a-time functions honour the reference's (accidental) signed-char
semantics: bytes >= 0x80 are sign-extended before mixing.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from hwbloomradixjoin.ops import u32 as U

_CRC32C_POLY_REFLECTED = np.uint32(0x82F63B78)


def _key_bytes(key, key_hi=None):
    """Bytes of the key, LSB first — 4 for int32 keys, 8 with KEY_8B."""
    k = U.u32(key)
    out = [(k >> (8 * i)) & jnp.uint32(0xFF) for i in range(4)]
    if key_hi is not None:
        kh = U.u32(key_hi)
        out += [(kh >> (8 * i)) & jnp.uint32(0xFF) for i in range(4)]
    return out


def hash_crc(seed, key, key_hi=None):
    """CRC-32C (Castagnoli) update of `seed` with the key bytes.

    Matches _mm_crc32_u32: reflected polynomial 0x11EDC6F41, no final
    inversion; branch-free 32-step reflected division.  Under KEY_8B the
    reference still calls the u32 intrinsic, truncating the key to its low 32
    bits (src/hash.c hash_crc takes the key through a uint32 operand), so
    key_hi is deliberately ignored.
    """
    del key_hi
    crc = U.u32(seed) ^ U.u32(key)
    for _ in range(32):
        mask = (jnp.uint32(0) - (crc & jnp.uint32(1))).astype(jnp.uint32)
        crc = (crc >> 1) ^ (_CRC32C_POLY_REFLECTED & mask)
    return crc


def hash_FNV(seed, key, key_hi=None):
    h = U.u32(seed) ^ jnp.uint32(2166136261)
    for b in _key_bytes(key, key_hi):
        h = h ^ U.sign_extend_byte(b)
        h = U.mul_lo(h, jnp.uint32(16777619))
    return h


def hash_crapwow(seed, key, key_hi=None):
    """CrapWow reduced to one int key (the bloom probe-sequence base hash)."""
    nbytes = 4 if key_hi is None else 8
    n = jnp.uint32(0x5052ACDB)
    h = jnp.full_like(U.u32(key), nbytes)
    k = (jnp.uint32(nbytes) + U.u32(seed) + n).astype(jnp.uint32) + jnp.zeros_like(h)

    def cwmixb(inp, h, k):
        hi, lo = U.mul_wide(inp, n)
        return h ^ lo, k ^ hi

    # cwfold casts its first operand to uint32 (src/hash.c cwfold macro), so
    # under KEY_8B only the key's low 32 bits are mixed — but h/k still start
    # from sizeof(intkey_t)=8.  key_hi therefore only selects nbytes above.
    h, k = cwmixb(U.u32(key), h, k)
    h, k = cwmixb(h ^ (k + n), h, k)
    return (k ^ h).astype(jnp.uint32)


def hash_Coffin(seed, key, key_hi=None):
    res = jnp.full_like(U.u32(key), 0x55555555)
    for b in _key_bytes(key, key_hi):
        res = res ^ U.sign_extend_byte(b)
        res = U.rotl32(res, 5)
    return res


def hash_MurmurOAAT_32(seed, key, key_hi=None):
    h = U.u32(seed) + jnp.zeros_like(U.u32(key))
    for b in _key_bytes(key, key_hi):
        h = h ^ U.sign_extend_byte(b)
        h = U.mul_lo(h, jnp.uint32(0x5BD1E995))
        h = h ^ (h >> 15)
    return h


def hash_JenkinsOAAT_32(seed, key, key_hi=None):
    h = U.u32(seed) + jnp.zeros_like(U.u32(key))
    for b in _key_bytes(key, key_hi):
        h = h + U.sign_extend_byte(b)
        h = h + (h << 10)
        h = h ^ (h >> 6)
    h = h + (h << 3)
    h = h ^ (h >> 11)
    h = h + (h << 15)
    return h.astype(jnp.uint32)


def hash_Spooky(seed, key, key_hi=None):
    """SpookyHash short-message variant on one int key (src/spooky.c).

    uint64 state carried as (hi, lo) uint32 pairs; the int32 key is
    sign-extended into the 64-bit message exactly as `sc_const + message` does.
    """
    nbytes = 4 if key_hi is None else 8
    seed = U.u32(seed) + jnp.zeros_like(U.u32(key))
    zero = jnp.zeros_like(seed)
    # h0 = h1 = (uint64)seed
    h0h, h0l = zero, seed
    h1h, h1l = zero, seed
    # c = sc_const + (int64)message
    if key_hi is None:
        msg_l = U.u32(key)
        msg_h = jnp.where(U.u32(key) >> 31 != 0, jnp.uint32(0xFFFFFFFF), jnp.uint32(0)).astype(jnp.uint32)
    else:
        msg_l, msg_h = U.u32(key), U.u32(key_hi)
    h2h, h2l = U.u64_add(jnp.uint32(0xDEADBEEF) + zero, jnp.uint32(0xDEADBEEF) + zero, msg_h, msg_l)
    # d = (uint64)nbytes << 56
    h3h, h3l = (jnp.uint32(nbytes) << 24) + zero, zero

    # ShortEnd mix schedule (spooky.h ShortEnd): (target ^=, rotated, added)
    # h3^=h2; h2=rot15; h3+=h2;  h0^=h3; h3=rot52; h0+=h3; ...
    sched = [
        (3, 2, 15), (0, 3, 52), (1, 0, 26), (2, 1, 51),
        (3, 2, 28), (0, 3, 9), (1, 0, 47), (2, 1, 54),
        (3, 2, 32), (0, 3, 25), (1, 0, 63),
    ]
    h = [[h0h, h0l], [h1h, h1l], [h2h, h2l], [h3h, h3l]]
    for (a, b, r) in sched:
        h[a][0], h[a][1] = U.u64_xor(h[a][0], h[a][1], h[b][0], h[b][1])
        h[b][0], h[b][1] = U.u64_rotl(h[b][0], h[b][1], r)
        h[a][0], h[a][1] = U.u64_add(h[a][0], h[a][1], h[b][0], h[b][1])
    return h[0][1]  # low 32 bits of h0


def hash_KR_v2(seed, key, key_hi=None):
    h = U.u32(seed) + jnp.zeros_like(U.u32(key))
    for b in _key_bytes(key, key_hi):
        h = U.sign_extend_byte(b) + U.mul_lo(h, jnp.uint32(31))
    return h.astype(jnp.uint32)


def hash_DJB2(seed, key, key_hi=None):
    # seed is unused in the reference implementation (src/hash.c DJB2)
    h = jnp.full_like(U.u32(key), 5381)
    for b in _key_bytes(key, key_hi):
        h = ((h << 5) + h + U.sign_extend_byte(b)).astype(jnp.uint32)
    return h


def hash_x17(seed, key, key_hi=None):
    h = U.u32(seed) + jnp.zeros_like(U.u32(key))
    for b in _key_bytes(key, key_hi):
        h = U.mul_lo(h, jnp.uint32(17)) + (U.sign_extend_byte(b) - jnp.uint32(32))
    h = h.astype(jnp.uint32)
    return h ^ (h >> 16)


# Registry in the reference's evaluation order (src/unit_tests.c test_hash)
HASH_FUNCTIONS = {
    "crc": hash_crc,
    "FNV": hash_FNV,
    "crapwow": hash_crapwow,
    "Coffin": hash_Coffin,
    "MurmurOAAT": hash_MurmurOAAT_32,
    "JenkinsOAAT": hash_JenkinsOAAT_32,
    "Spooky": hash_Spooky,
    "KR_v2": hash_KR_v2,
    "DJB2": hash_DJB2,
    "x17": hash_x17,
}
