"""Radix sort / radix clustering operators.

The reference's radix-clustering pass *is* an MSB radix-sort pass
(radix_cluster, parallel_radix_join.c:570); exposed here as standalone
operators over (key, payload) columns:

- ``radix_cluster``: MSB-clusters the rows into 2^bits contiguous bucket
  runs of the key range and returns each run's start (BASELINE operator
  set #10): a stable sort on the bucket bits alone.
- ``radix_sort``: full ordering via jax.lax.sort.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def radix_cluster(keys, lo: int, hi: int, bits: int, *payloads):
    """MSB radix-cluster rows by key into 2^bits buckets of [lo, hi].

    Returns (keys, *payloads, starts): the rows in bucket order, stable
    within a bucket, and starts (2^bits + 1,) with bucket b's run at
    [starts[b], starts[b + 1]).  Keys outside [lo, hi] follow the last
    bucket, from starts[2^bits] on.
    """
    span = hi - lo + 1
    shift = max((span - 1).bit_length() - bits, 0)
    keys = jnp.asarray(keys, jnp.int32)
    ok = (keys >= lo) & (keys <= hi)
    bucket = jnp.where(ok, (keys - jnp.int32(lo)) >> shift, 1 << bits)
    out = jax.lax.sort((bucket, keys, *payloads), num_keys=1, is_stable=True)
    starts = jnp.searchsorted(out[0], jnp.arange((1 << bits) + 1),
                              side="left").astype(jnp.int32)
    return (*out[1:], starts)


def radix_sort(keys, *payloads, descending: bool = False):
    """Sort rows by key; payload columns follow.  Stable."""
    ops = (keys, *payloads)
    if descending:
        out = jax.lax.sort(tuple(jnp.bitwise_not(keys) if i == 0 else o
                                 for i, o in enumerate(ops)), num_keys=1,
                           is_stable=True)
        return (jnp.bitwise_not(out[0]), *out[1:])
    out = jax.lax.sort(ops, num_keys=1, is_stable=True)
    return out if len(ops) > 1 else out[0]
