"""Device-resident count-table join (the NPO family's vectorized form).

The reference NPO builds one shared bucket-chained hash table over R with
per-bucket spinlatches and probes it per-thread (no_partitioning_join.c:432,
:279).  The vectorized equivalent replaces the latched chains with a
*perfect-addressed count table* in HBM:

  build:  cnt[key] += 1 and paysum[key] += payload  (deterministic
          scatter-add — the lock-free analogue of the latched append)
  probe:  per S tuple one gather: matches = cnt[s_key], and the R-payload
          checksum contribution is paysum[s_key]

This is exact (not approximate) for any key multiset: the "hash" is the
identity over the declared key range [min_key, max_key], so there are no
collisions and no chains to walk.  Memory = 4-8 bytes per key-range slot;
the planner uses it when the range fits device memory comfortably (the reference
workloads keep keys in [1, maxid] with maxid = |R| or INT_MAX*sel,
src/main.c:416-467 — dense-ish ranges by construction).

Random-access cost model: build = |R| scattered read-modify-writes, probe =
|S| random gathers — the same memory-access shape as the reference NPO probe
(one cacheline per probe when BUCKET_SIZE=2, npj_params.h), so HBM random
bandwidth is the roofline on both designs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hwbloomradixjoin.ops import u32 as U


def build_tables(r_key, r_pay, lo: int, hi: int, with_paysum: bool = True):
    """Build phase: multiplicity table (+ payload-sum table) over [lo, hi].

    The deterministic scatter-add replacement for the reference's latched
    bucket append (build_hashtable_mt, no_partitioning_join.c:432-488).
    """
    nslots = hi - lo + 1
    r_idx = r_key.astype(jnp.int32) - jnp.int32(lo)
    r_ok = (r_key >= lo) & (r_key <= hi)
    r_idx = jnp.where(r_ok, r_idx, nslots)
    cnt_tbl = jnp.zeros(nslots, jnp.int32).at[r_idx].add(
        jnp.int32(1), mode="drop")
    if not with_paysum:
        return cnt_tbl, jnp.zeros(0, jnp.uint32)
    pay_tbl = jnp.zeros(nslots, jnp.uint32).at[r_idx].add(
        jnp.where(r_ok, U.u32(r_pay), jnp.uint32(0)), mode="drop")
    return cnt_tbl, pay_tbl


def probe_tables(cnt_tbl, pay_tbl, s_key, s_pay, lo: int, hi: int):
    """Probe phase: one gather per S tuple (vectorized chain-walk analog)."""
    s_ok = (s_key >= lo) & (s_key <= hi)
    s_idx = jnp.where(s_ok, s_key.astype(jnp.int32) - jnp.int32(lo), 0)
    mult = jnp.where(s_ok, cnt_tbl[s_idx], 0)
    count = jnp.sum(mult, dtype=jnp.int32)
    if pay_tbl.shape[0]:
        sum_rpay = jnp.sum(jnp.where(s_ok, pay_tbl[s_idx], jnp.uint32(0)),
                           dtype=jnp.uint32)
    else:
        sum_rpay = jnp.uint32(0)
    sum_spay = jnp.sum(U.u32(s_pay) * U.u32(mult), dtype=jnp.uint32)
    return count, sum_rpay, sum_spay


def counttable_join_count(r_key, r_pay, s_key, s_pay,
                          lo: int, hi: int, with_checksums: bool = True):
    """Join count (+ checksums) via a perfect-addressed count table.

    lo/hi: static declared key range of R (table covers [lo, hi]).
    Keys outside the range on the S side cannot match and are masked;
    R keys outside the range would be dropped (callers pass the true range).
    PAD_KEY slots on either side are ignored (they fall outside [lo, hi]).

    Returns (count, sum_rpay, sum_spay) exactly like sort_scan_count.
    """
    cnt_tbl, pay_tbl = build_tables(r_key, r_pay, lo, hi,
                                    with_paysum=with_checksums)
    return probe_tables(cnt_tbl, pay_tbl, s_key, s_pay, lo, hi)


def counttable_probe_mask(r_key, s_key, lo: int, hi: int):
    """Exact membership mask of S keys in R (unique-R fast predicate)."""
    nslots = hi - lo + 1
    r_idx = jnp.where((r_key >= lo) & (r_key <= hi),
                      r_key.astype(jnp.int32) - jnp.int32(lo), nslots)
    bm = jnp.zeros(nslots, jnp.int32).at[r_idx].max(jnp.int32(1), mode="drop")
    s_ok = (s_key >= lo) & (s_key <= hi)
    s_idx = jnp.where(s_ok, s_key.astype(jnp.int32) - jnp.int32(lo), 0)
    return s_ok & (bm[s_idx] > 0)
