"""Skew-aware repartitioning for the distributed shuffle.

The reference's SKEW_HANDLING (parallel_radix_join_bloom.c:1175-1415) detects
partitions exceeding THRESHOLD1 from the histogram, re-partitions them
cooperatively, and splits the probe side of still-heavy partitions across
threads sharing one build side.

SPMD redesign: heavy *keys* (Zipf z>=0.75 probe side) concentrate hash mass
on one destination device.  From the global destination histogram (psum),
destinations whose S load exceeds ``factor`` x mean are flagged heavy; their
S tuples are re-routed round-robin over all devices while the matching R
tuples are REPLICATED to every device (broadcast join for the hot range):
replicate-R/split-S.  Counting joins stay exact because every S tuple still
meets each matching R tuple exactly once (its R partners live replicated on
the device the S tuple landed on).

Used by parallel/dist_join.py when skew_handling is enabled.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hwbloomradixjoin.parallel.mesh import AXIS


def heavy_dest_mask(dest, n_dev: int, factor: float = 2.0, valid=None):
    """Global per-destination S-load histogram -> heavy-destination mask.

    Runs inside shard_map: psum of local destination histograms (the SPMD
    form of the reference's histogram-threshold test).  Returns a bool
    (n_dev,) mask, replicated.
    """
    if valid is None:
        valid = jnp.ones(dest.shape, bool)
    onehot = (dest[:, None] == jnp.arange(n_dev, dtype=jnp.int32)[None, :])
    local = jnp.sum(onehot & valid[:, None], axis=0, dtype=jnp.int32)
    glob = jax.lax.psum(local, AXIS)
    total = jnp.sum(glob)
    mean = jnp.maximum(total // n_dev, 1)
    return glob > (mean * factor).astype(glob.dtype)


def split_heavy_dests(dest, heavy, n_dev: int, salt):
    """Re-route tuples bound for heavy destinations round-robin.

    `salt` is a per-tuple int (e.g. local index) providing the round-robin
    spread.  Non-heavy destinations are unchanged.
    """
    spread = (salt % n_dev).astype(jnp.int32)
    return jnp.where(heavy[dest], spread, dest)


def replicate_mask_for_r(dest, heavy):
    """R tuples whose destination is heavy must be replicated to all devices."""
    return heavy[dest]
