"""Bloom filter math — exact reference semantics, vectorized.

Reproduces src/bloom_filter.c bit-for-bit:

- probe sequence: *enhanced double hashing* with h0 = crapwow(seed, key) and
  stride y0 = key + seed, iterated h += y; y += i+1 (mod m or B)
  (add_generic/contains_generic, bloom_filter.c:73-111)
- basic variant: one m-bit bitmap
- blocked variant: block = crc32c(seed, key) mod nblocks, probes confined to
  one B-bit block (bloom_filter.c:125-141)

This module provides the vectorized position/bit math shared by every
execution tier:
- host (numpy) build/probe for validation and the FPR test harness
- jnp build/probe used by the join programs (single- and multi-device)

FPR parity with measurements/data/bloom_filter_fpr.txt is asserted in
tests/test_bloom.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from hwbloomradixjoin.config import BloomArgs, BloomVariant
from hwbloomradixjoin.ops import hashes
from hwbloomradixjoin.ops import u32 as U


def probe_positions(keys, seed, size: int, k: int):
    """The k probe bit-positions for each key, in a `size`-bit space.

    Returns a list of k uint32 arrays (one per probe round); size must be a
    power of two (m for basic, B for blocked).
    """
    mask = jnp.uint32(size - 1)
    h = hashes.hash_crapwow(jnp.uint32(seed), keys) & mask
    y = (U.u32(keys) + jnp.uint32(seed)) & mask
    out = []
    for i in range(k):
        out.append(h)
        h = (h + y) & mask
        y = (y + jnp.uint32(i + 1)) & mask
    return out


def block_index(keys, seed, nblocks: int):
    """Blocked-variant block selector: crc32c(seed, key) mod nblocks."""
    return hashes.hash_crc(jnp.uint32(seed), keys) & jnp.uint32(nblocks - 1)


def global_positions(keys, args: BloomArgs):
    """Absolute bit positions in the m-bit bitmap for each of the k probes."""
    if args.variant == BloomVariant.BASIC:
        return probe_positions(keys, args.seed, args.m, args.k)
    base = U.u32(block_index(keys, args.seed, args.nblocks)) * jnp.uint32(args.B)
    return [base + p for p in probe_positions(keys, args.seed, args.B, args.k)]


# ---------------------------------------------------------------------------
# Host (numpy) build/probe — ground truth and harness path
# ---------------------------------------------------------------------------

def build_bitmap_host(keys: np.ndarray, args: BloomArgs) -> np.ndarray:
    """Build the filter bitmap as a uint32-word array (m/32 words)."""
    bitmap = np.zeros(args.m // 32, dtype=np.uint32)
    for pos in global_positions(np.asarray(keys), args):
        pos = np.asarray(pos)
        np.bitwise_or.at(bitmap, pos >> 5, np.uint32(1) << (pos & 31))
    return bitmap


def probe_bitmap_host(bitmap: np.ndarray, keys: np.ndarray,
                      args: BloomArgs) -> np.ndarray:
    """contains() for each key against a uint32-word bitmap."""
    ok = np.ones(len(keys), dtype=bool)
    for pos in global_positions(np.asarray(keys), args):
        pos = np.asarray(pos)
        word = bitmap[pos >> 5]
        ok &= (word >> (pos & 31)) & 1 != 0
    return ok


def theoretical_fpr(m: int, k: int, n: int) -> float:
    """FPR = (1 - (1 - 1/m)^(k n))^k (unit_tests.c:231-232, analysis.py:63-67)."""
    return (1.0 - (1.0 - 1.0 / m) ** (k * n)) ** k


# ---------------------------------------------------------------------------
# In-graph (XLA) build/probe — portable tier used by the bloom join models.
# The reference builds with relaxed atomic fetch-or (bloom_filter.c:84); here
# the equivalent is a deterministic sort-dedup-reduce: distinct bit positions
# per word sum to the word's OR, so no atomics and no scatter-OR are needed.
# ---------------------------------------------------------------------------

def build_bitmap_xla(keys, args: BloomArgs):
    """Filter bitmap (uint32[m/32]) as a jitted XLA computation."""
    import jax

    pos_list = global_positions(keys, args)
    pos = jnp.concatenate([p.reshape(-1) for p in pos_list]).astype(jnp.uint32)
    pos = jax.lax.sort(pos.astype(jnp.int32))  # positions < 2^31 (m <= 2^30)
    uniq = jnp.concatenate([jnp.ones(1, bool), pos[1:] != pos[:-1]])
    word = (pos >> 5).astype(jnp.int32)
    bit = (U.u32(pos) & jnp.uint32(31))
    val = jnp.where(uniq, jnp.uint32(1) << bit, jnp.uint32(0))
    return jax.ops.segment_sum(val, word, num_segments=args.m // 32)


def probe_bitmap_xla(bitmap, keys, args: BloomArgs):
    """contains() mask for keys against a uint32-word bitmap, in-graph."""
    ok = jnp.ones(keys.shape, dtype=bool)
    for pos in global_positions(keys, args):
        word = bitmap[(pos >> 5).astype(jnp.int32)]
        ok = ok & (((word >> (pos & jnp.uint32(31))) & jnp.uint32(1)) != 0)
    return ok
