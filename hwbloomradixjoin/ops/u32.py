"""Vectorized uint32 / uint64 lattice arithmetic for hash kernels.

The engine runs with 32-bit integers (jax x64 disabled); the reference hash
math needs uint32 wraparound semantics, 32x32->64 products (CrapWow), and
full uint64 add/rot/xor (SpookyHash).  This module provides those as
branch-free jnp ops that work identically under jit on any backend and in
numpy-backed tests.

All functions take/return uint32 arrays (uint64 values as (hi, lo) pairs).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)


def u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def mul_lo(a, b):
    """Low 32 bits of a*b (native wraparound multiply)."""
    return (u32(a) * u32(b)).astype(jnp.uint32)


def mul_hi(a, b):
    """High 32 bits of the 64-bit product a*b, via 16-bit limbs.

    a*b = (ah*bh << 32) + ((ah*bl + al*bh) << 16) + al*bl
    Carries are tracked exactly in uint32.
    """
    a = u32(a)
    b = u32(b)
    al = a & _MASK16
    ah = a >> 16
    bl = b & _MASK16
    bh = b >> 16
    ll = al * bl          # <= (2^16-1)^2, fits u32
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    # mid = lh + hl + (ll >> 16); mid can carry past 32 bits
    mid = lh + (ll >> 16)
    mid2 = mid + hl
    carry = (mid2 < hl).astype(jnp.uint32)  # wrapped => carry into bit 32
    return hh + (mid2 >> 16) + (carry << 16)


def mul_wide(a, b):
    """Full 64-bit product as (hi, lo) uint32 pair."""
    return mul_hi(a, b), mul_lo(a, b)


def rotl32(x, r: int):
    x = u32(x)
    r = int(r) & 31
    if r == 0:
        return x
    return ((x << r) | (x >> (32 - r))).astype(jnp.uint32)


# ---------------------------------------------------------------------------
# uint64 as (hi, lo) uint32 pairs
# ---------------------------------------------------------------------------

def u64_add(ah, al, bh, bl):
    lo = (u32(al) + u32(bl)).astype(jnp.uint32)
    carry = (lo < u32(bl)).astype(jnp.uint32)
    hi = (u32(ah) + u32(bh) + carry).astype(jnp.uint32)
    return hi, lo


def u64_add_u32(ah, al, b):
    return u64_add(ah, al, jnp.uint32(0), b)


def u64_xor(ah, al, bh, bl):
    return (u32(ah) ^ u32(bh)), (u32(al) ^ u32(bl))


def u64_rotl(ah, al, r: int):
    """Rotate a 64-bit (hi, lo) pair left by r."""
    r = int(r) & 63
    ah, al = u32(ah), u32(al)
    if r == 0:
        return ah, al
    if r == 32:
        return al, ah
    if r < 32:
        hi = ((ah << r) | (al >> (32 - r))).astype(jnp.uint32)
        lo = ((al << r) | (ah >> (32 - r))).astype(jnp.uint32)
    else:
        s = r - 32
        hi = ((al << s) | (ah >> (32 - s))).astype(jnp.uint32)
        lo = ((ah << s) | (al >> (32 - s))).astype(jnp.uint32)
    return hi, lo


def sign_extend_byte(b):
    """View the low 8 bits of b as a signed char, widened to uint32.

    The reference hash loops assign bytes to (signed) `char` and then mix them
    into uint32 state, so bytes >= 0x80 enter sign-extended
    (e.g. src/hash.c FNV/Murmur/Jenkins/KR/DJB2/x17/Coffin byte loops).
    """
    b = u32(b) & jnp.uint32(0xFF)
    return jnp.where(b >= jnp.uint32(0x80), b | jnp.uint32(0xFFFFFF00), b).astype(jnp.uint32)
