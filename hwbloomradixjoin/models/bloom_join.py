"""BPRO / BPRH / BPRHO / BRJ — bloom-filtered radix joins.

Reference pattern (parallel_radix_join_bloom.c:758-852): the filter build is
fused into R's pass-1 partitioning (every R key inserted while histogramming)
and the filter probe into S's pass-1 (non-matching tuples dropped before the
scatter, with a per-thread bitmap memoizing the check); the filtered S
cardinality is recomputed from the histograms and reported as
"S-tuples after filter" (:1253).

This engine keeps the same dataflow: build the filter from R, prune S
*before* any partitioning/shuffle work, then join the survivors.  In the
distributed tier pruning happens before the all-to-all, so dropped tuples
are never exchanged.  XLA shapes being static, the pruned S keeps capacity
|S| with dropped slots holding PAD_KEY (which never matches — generators
produce keys >= 0 only).
"""

from __future__ import annotations

import jax.numpy as jnp

from hwbloomradixjoin.config import BloomArgs
from hwbloomradixjoin.ops import bloom, xla_join
from hwbloomradixjoin.types import Relation


def bloom_prune(r_key, s_key, args: BloomArgs):
    """Build filter from R, return S survival mask + surviving count."""
    bitmap = bloom.build_bitmap_xla(r_key, args)
    mask = bloom.probe_bitmap_xla(bitmap, s_key, args)
    return mask, jnp.sum(mask, dtype=jnp.int32)


def bloom_radix_count(r_key, r_pay, s_key, s_pay, args: BloomArgs,
                      variant: str = "BPRO"):
    """Bloom-pruned radix join: returns (count, sum_rpay, sum_spay, s_after).

    Pruned S slots are masked to PAD_KEY rather than compacted (static
    shapes); the join ignores them because PAD_KEY never occurs in R.
    """
    del variant
    mask, s_after = bloom_prune(r_key, s_key, args)
    s_key_f = jnp.where(mask, s_key, jnp.int32(Relation.PAD_KEY))
    cnt, sr, ss = xla_join.sort_scan_count(r_key, r_pay, s_key_f, s_pay)
    return cnt, sr, ss, s_after
