"""Hash aggregate (group-by) operator.

The reference implies this operator through its analysis workloads (the
BASELINE Zipf config runs a hash aggregate over the join output); radix
clustering is the shared machinery.  Formulation: group-by = sort +
segmented reduction (deterministic, gather-free), the same segmented-scan
core as the join's sort tier.

API mirrors a vectorized aggregate: returns capacity-padded unique keys with
per-group count/sum columns and the dynamic group count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hwbloomradixjoin.ops import u32 as U


def group_by_key(keys, values=None):
    """Group rows by key: (unique_keys, counts, sums, num_groups).

    Outputs are capacity-|keys| arrays; entries past num_groups hold
    PAD (int32 min) / 0.  `sums` is the uint32 wraparound sum of `values`
    per group (0s if values is None).
    """
    n = keys.shape[0]
    if values is None:
        values = jnp.zeros_like(keys)
    k_s, v_s = jax.lax.sort((keys, values), num_keys=1)

    boundary = jnp.concatenate([jnp.ones(1, bool), k_s[1:] != k_s[:-1]])
    idx = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, jnp.int32(-1)))

    ones = jnp.ones(n, jnp.uint32)
    cnt_pref = jnp.cumsum(ones, dtype=jnp.uint32) - ones
    val_u = U.u32(v_s)
    val_pref = jnp.cumsum(val_u, dtype=jnp.uint32) - val_u

    # last row of each segment carries the totals
    is_last = jnp.concatenate([k_s[1:] != k_s[:-1], jnp.ones(1, bool)])
    seg_cnt = (cnt_pref + ones) - cnt_pref[seg_start]
    seg_sum = (val_pref + val_u) - val_pref[seg_start]

    num_groups = jnp.sum(boundary, dtype=jnp.int32)
    # compact the per-segment rows to the front: sort by (not-last, position)
    order_key = jnp.where(is_last, idx, idx + n)
    _, uk, uc, us = jax.lax.sort(
        (order_key, k_s, seg_cnt.astype(jnp.int32), seg_sum.astype(jnp.int32)),
        num_keys=1)
    pad = jnp.arange(n) >= num_groups
    uk = jnp.where(pad, jnp.int32(-2147483648), uk)
    uc = jnp.where(pad, 0, uc)
    us = jnp.where(pad, 0, us)
    return uk, uc.astype(jnp.int32), us.astype(jnp.uint32), num_groups


def join_group_count(r_key, s_key):
    """Aggregate over the join output without materializing it.

    For each key present on both sides, the joined-output group size is
    r_multiplicity * s_multiplicity.  Returns (keys, group_counts,
    num_groups) capacity-padded to min side... capacity = |R| (distinct join
    keys cannot exceed distinct R keys).
    """
    rk_u, rc, _, nr_g = group_by_key(r_key)
    sk_u, sc, _, ns_g = group_by_key(s_key)
    # match the two grouped tables (both unique) via sort-scan
    key = jnp.concatenate([rk_u, sk_u])
    side = jnp.concatenate([jnp.zeros_like(rc), jnp.ones_like(sc)])
    cnt = jnp.concatenate([rc, sc])
    key, side, cnt = jax.lax.sort((key, side, cnt), num_keys=2)
    # adjacent (r,s) rows with equal key => joined group
    match = (key[:-1] == key[1:]) & (side[:-1] == 0) & (side[1:] == 1) \
        & (key[:-1] != jnp.int32(-2147483648))
    group_cnt = cnt[:-1] * cnt[1:]
    n = r_key.shape[0]
    ng = jnp.sum(match, dtype=jnp.int32)
    idx = jnp.arange(key.shape[0] - 1, dtype=jnp.int32)
    order = jnp.where(match, idx, idx + key.shape[0])
    _, out_key, out_cnt = jax.lax.sort(
        (order, key[:-1], jnp.where(match, group_cnt, 0)), num_keys=1)
    return out_key[:n], out_cnt[:n], ng
