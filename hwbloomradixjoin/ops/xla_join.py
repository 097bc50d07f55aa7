"""Sort-based join operators, left to XLA.

Pure jnp/lax formulations that run on any backend (the GPU, CPU test
meshes), validated against the native scalar ground truth
(data/native.ref_join).  The engine's sort tiers (sortscan, key8b,
materialize, materialize8b) are built from them.

Two formulations:

- ``sort_scan_count``: sort-based join count (+ payload checksums).
  Replaces the reference's chain-walk probe (bucket_chaining_join,
  parallel_radix_join.c:255) with a deterministic sort + segmented scan:
  R rows sort before S rows within a key, so each S row's match count is the
  number of R rows in its key segment.  O(n log n), race-free, duplicate keys
  allowed on both sides.

- ``csr_hash_join_count``: the NPO structure (no_partitioning_join.c:432-330)
  without locks: R bucketized by hash into a CSR layout (sort by bucket +
  prefix offsets), S probes scan their bucket's dense window.  The per-bucket
  latch build is replaced by a sort and the linked overflow-bucket walk
  (npj_types.h BUCKET_SIZE=2 chains) by a bounded window compare.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hwbloomradixjoin.ops import u32 as U


def sort_scan_count(r_key, r_pay, s_key, s_pay):
    """Join match count + uint32 payload checksums (mod-2^32 of ref_join sums).

    Returns (count:int32, sum_r_payload:uint32, sum_s_payload:uint32) over all
    matched (r, s) pairs.
    """
    nr = r_key.shape[0]
    ns = s_key.shape[0]
    key = jnp.concatenate([r_key, s_key])
    tag = jnp.concatenate([jnp.zeros(nr, jnp.int32), jnp.ones(ns, jnp.int32)])
    pay = jnp.concatenate([r_pay, s_pay])
    key, tag, pay = jax.lax.sort((key, tag, pay), num_keys=2)
    return scan_sorted_count(key, tag, pay)


def scan_sorted_count(key, tag, pay):
    """The probe half of sort_scan_count: segmented scan over sorted input.

    Split out so the driver can time the clustering (sort) and probe (scan)
    phases as separate dispatches — the reference's PART vs PROBE split
    (print_timing, parallel_radix_join_bloom.c:1509-1547).
    """
    n = key.shape[0]
    is_r = tag == 0
    boundary = jnp.concatenate([jnp.ones(1, bool), key[1:] != key[:-1]])
    idx = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, jnp.int32(-1)))

    # exclusive prefixes; base value at segment start recovers per-segment sums
    r_flag = is_r.astype(jnp.uint32)
    r_pref = jnp.cumsum(r_flag, dtype=jnp.uint32) - r_flag
    rp_val = jnp.where(is_r, U.u32(pay), jnp.uint32(0))
    rp_pref = jnp.cumsum(rp_val, dtype=jnp.uint32) - rp_val

    r_in_seg = r_pref - r_pref[seg_start]        # uint32, wrap-safe difference
    rp_in_seg = rp_pref - rp_pref[seg_start]
    s_rows = ~is_r
    count = jnp.sum(jnp.where(s_rows, r_in_seg, 0).astype(jnp.int64)
                    if jax.config.x64_enabled else
                    jnp.where(s_rows, r_in_seg, 0).astype(jnp.int32))
    sum_rpay = jnp.sum(jnp.where(s_rows, rp_in_seg, jnp.uint32(0)),
                       dtype=jnp.uint32)
    sum_spay = jnp.sum(jnp.where(s_rows, U.u32(pay) * r_in_seg, jnp.uint32(0)),
                       dtype=jnp.uint32)
    return count, sum_rpay, sum_spay


def sort_scan_materialize(r_key, r_pay, s_key, s_pay):
    """Materialized join for a unique-key build side (PK-FK joins).

    The reference's JOIN_RESULT_MATERIALIZE mode appends <R.payload,
    S.payload> pairs to chained per-thread buffers (src/tuple_buffer.h);
    here the output is a pair of capacity-|S| columns with `count` valid
    rows (each S row matches at most one R row when R keys are unique),
    compacted deterministically by sort.

    Returns (count, r_payload_out, s_payload_out, key_out).
    """
    nr = r_key.shape[0]
    ns = s_key.shape[0]
    n = nr + ns
    key = jnp.concatenate([r_key, s_key])
    tag = jnp.concatenate([jnp.zeros(nr, jnp.int32), jnp.ones(ns, jnp.int32)])
    pay = jnp.concatenate([r_pay, s_pay])
    key, tag, pay = jax.lax.sort((key, tag, pay), num_keys=2)

    is_r = tag == 0
    boundary = jnp.concatenate([jnp.ones(1, bool), key[1:] != key[:-1]])
    idx = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, jnp.int32(-1)))

    r_flag = is_r.astype(jnp.int32)
    r_pref = jnp.cumsum(r_flag) - r_flag
    r_in_seg = r_pref - r_pref[seg_start]
    # R payload of the segment head (the R row sorts first within its key;
    # valid exactly when r_in_seg == 1)
    head_pay = pay[seg_start]
    matched = (~is_r) & (r_in_seg == 1)
    count = jnp.sum(matched, dtype=jnp.int32)

    order = jnp.where(matched, idx, idx + n)
    _, out_r, out_s, out_k = jax.lax.sort(
        (order,
         jnp.where(matched, head_pay, 0),
         jnp.where(matched, pay, 0),
         jnp.where(matched, key, jnp.int32(-2147483648))), num_keys=1)
    return count, out_r[:ns], out_s[:ns], out_k[:ns]


def sort_scan_count_wide(r_hi, r_lo, r_pay, s_hi, s_lo, s_pay):
    """sort_scan_count for 64-bit keys carried as (hi, lo) int32 columns.

    The KEY_8B build of the reference widens intkey_t/value_t to int64
    (src/types.h:22-28) — 16B tuples, workload A.  Here a 64-bit key is two
    int32 columns; the sort orders by (hi, lo-as-unsigned, tag) and
    segments break where either word changes.
    """
    nr = r_lo.shape[0]
    ns = s_lo.shape[0]
    n = nr + ns
    # flip sign bit so int32 sort orders lo as unsigned
    flip = jnp.int32(-2147483648)
    hi = jnp.concatenate([r_hi, s_hi])
    lo = jnp.concatenate([r_lo, s_lo]) ^ flip
    tag = jnp.concatenate([jnp.zeros(nr, jnp.int32), jnp.ones(ns, jnp.int32)])
    pay = jnp.concatenate([r_pay, s_pay])
    hi, lo, tag, pay = jax.lax.sort((hi, lo, tag, pay), num_keys=3)

    is_r = tag == 0
    boundary = jnp.concatenate(
        [jnp.ones(1, bool), (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])])
    idx = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, jnp.int32(-1)))

    r_flag = is_r.astype(jnp.uint32)
    r_pref = jnp.cumsum(r_flag, dtype=jnp.uint32) - r_flag
    rp_val = jnp.where(is_r, U.u32(pay), jnp.uint32(0))
    rp_pref = jnp.cumsum(rp_val, dtype=jnp.uint32) - rp_val
    r_in_seg = r_pref - r_pref[seg_start]
    rp_in_seg = rp_pref - rp_pref[seg_start]
    s_rows = ~is_r
    count = jnp.sum(jnp.where(s_rows, r_in_seg, 0).astype(jnp.int32))
    sum_rpay = jnp.sum(jnp.where(s_rows, rp_in_seg, jnp.uint32(0)),
                       dtype=jnp.uint32)
    sum_spay = jnp.sum(jnp.where(s_rows, U.u32(pay) * r_in_seg, jnp.uint32(0)),
                       dtype=jnp.uint32)
    return count, sum_rpay, sum_spay


def hash_multiplicative(keys, bits: int):
    """Cheap bucket hash: Knuth multiplicative on uint32, top `bits` bits."""
    h = U.mul_lo(U.u32(keys), jnp.uint32(2654435761))
    return (h >> jnp.uint32(32 - bits)).astype(jnp.int32)


def csr_hash_join_count(r_key, r_pay, s_key, s_pay, bits: int | None = None,
                        max_bucket: int = 8):
    """NPO-shaped join: CSR-bucketized R table, windowed probe.

    bits: log2(#buckets); defaults to ~2 tuples/bucket like the reference's
    BUCKET_SIZE=2 (npj_params.h:18).
    max_bucket: static probe-window bound; the returned `overflow` flag is
    True if any bucket exceeded it (callers must then retry with a larger
    window — uniform unique keys keep buckets tiny).
    """
    nr = r_key.shape[0]
    if bits is None:
        bits = max((max(nr // 2, 1) - 1).bit_length(), 1)
    nbuckets = 1 << bits

    rb = hash_multiplicative(r_key, bits)
    order = jnp.argsort(rb, stable=True)
    rk_s = r_key[order]
    rp_s = r_pay[order]
    rb_s = rb[order]
    offsets = jnp.searchsorted(rb_s, jnp.arange(nbuckets + 1, dtype=jnp.int32),
                               method="scan_unrolled")
    counts = (offsets[1:] - offsets[:-1]).astype(jnp.int32)
    overflow = jnp.max(counts) > max_bucket

    sb = hash_multiplicative(s_key, bits)
    start = offsets[sb].astype(jnp.int32)
    scount = counts[sb]
    cnt = jnp.int32(0)
    sum_rp = jnp.uint32(0)
    sum_sp = jnp.uint32(0)
    for j in range(max_bucket):
        idx = jnp.minimum(start + j, nr - 1)
        hit = (j < scount) & (rk_s[idx] == s_key)
        cnt = cnt + jnp.sum(hit, dtype=jnp.int32)
        sum_rp = sum_rp + jnp.sum(jnp.where(hit, U.u32(rp_s[idx]), jnp.uint32(0)),
                                  dtype=jnp.uint32)
        sum_sp = sum_sp + jnp.sum(jnp.where(hit, U.u32(s_pay), jnp.uint32(0)),
                                  dtype=jnp.uint32)
    return cnt, sum_rp, sum_sp, overflow


def _awc(a, b):
    """Associative add-with-carry on (hi, lo) uint32 pairs = 64-bit add."""
    ah, al = a
    bh, bl = b
    lo = al + bl
    carry = (lo < bl).astype(jnp.uint32)
    return ah + bh + carry, lo


def _sub64(ah, al, bh, bl):
    lo = al - bl
    borrow = (al < bl).astype(jnp.uint32)
    return ah - bh - borrow, lo


def _sum64(hi, lo):
    """Sum of (hi, lo) uint32 pair vectors mod 2^64 (associative scan)."""
    h, l = jax.lax.associative_scan(_awc, (hi, lo))
    return h[-1], l[-1]


def sort_scan_count_wide64(r_khi, r_klo, r_phi, r_plo,
                           s_khi, s_klo, s_phi, s_plo):
    """64-bit keys AND 64-bit payloads: count + both checksums mod 2^64.

    Completes KEY_8B parity: the reference widens value_t to int64 along
    with intkey_t (src/types.h:22-28), so checksums accumulate mod 2^64.
    All 64-bit arithmetic rides (hi, lo) uint32 pairs (ops/u32.py) — jax
    x64 stays off, so every column stays 32 bits wide.
    Returns (count, (sum_rpay_hi, sum_rpay_lo), (sum_spay_hi, sum_spay_lo)).
    """
    nr = r_klo.shape[0]
    ns = s_klo.shape[0]
    flip = jnp.int32(-2147483648)
    khi = jnp.concatenate([r_khi, s_khi])
    klo = jnp.concatenate([r_klo, s_klo]) ^ flip
    tag = jnp.concatenate([jnp.zeros(nr, jnp.int32), jnp.ones(ns, jnp.int32)])
    phi = jnp.concatenate([r_phi, s_phi])
    plo = jnp.concatenate([r_plo, s_plo])
    khi, klo, tag, phi, plo = jax.lax.sort((khi, klo, tag, phi, plo),
                                           num_keys=3)

    n = nr + ns
    is_r = tag == 0
    boundary = jnp.concatenate(
        [jnp.ones(1, bool), (khi[1:] != khi[:-1]) | (klo[1:] != klo[:-1])])
    idx = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, jnp.int32(-1)))

    r_flag = is_r.astype(jnp.uint32)
    r_pref = jnp.cumsum(r_flag, dtype=jnp.uint32) - r_flag
    r_in_seg = r_pref - r_pref[seg_start]
    s_rows = ~is_r

    # 64-bit prefix of R payloads (exclusive), then per-segment delta
    rp_hi = jnp.where(is_r, U.u32(phi), jnp.uint32(0))
    rp_lo = jnp.where(is_r, U.u32(plo), jnp.uint32(0))
    pr_hi, pr_lo = jax.lax.associative_scan(_awc, (rp_hi, rp_lo))
    pr_hi, pr_lo = _sub64(pr_hi, pr_lo, rp_hi, rp_lo)      # exclusive
    d_hi, d_lo = _sub64(pr_hi, pr_lo, pr_hi[seg_start], pr_lo[seg_start])

    count = jnp.sum(jnp.where(s_rows, r_in_seg, 0).astype(jnp.int32))
    sum_r = _sum64(jnp.where(s_rows, d_hi, jnp.uint32(0)),
                   jnp.where(s_rows, d_lo, jnp.uint32(0)))

    # S checksum: s_pay (64-bit) * match count, mod 2^64
    c = jnp.where(s_rows, r_in_seg, jnp.uint32(0))
    sp_lo_c = U.mul_lo(U.u32(plo), c)
    sp_hi_c = U.mul_hi(U.u32(plo), c) + U.mul_lo(U.u32(phi), c)
    sum_s = _sum64(sp_hi_c, sp_lo_c)
    return count, sum_r, sum_s


def sort_scan_materialize_multi(r_key, r_pay, s_key, s_pay, out_cap: int):
    """Materialized join for NON-UNIQUE build sides: all (R, S) pairs.

    Each S row with key multiplicity m in R emits m pairs (the
    reference's materialization is all-pairs, tuple_buffer.h appends one
    entry per probe hit, parallel_radix_join.c:255-330).  out_cap is the
    static output capacity (callers pre-count with sort_scan_count);
    rows past the true total carry PAD keys.

    Returns (count, r_payload_out, s_payload_out, key_out) with out_cap
    rows.
    """
    nr = r_key.shape[0]
    ns = s_key.shape[0]
    n = nr + ns
    key = jnp.concatenate([r_key, s_key])
    tag = jnp.concatenate([jnp.zeros(nr, jnp.int32), jnp.ones(ns, jnp.int32)])
    pay = jnp.concatenate([r_pay, s_pay])
    key, tag, pay = jax.lax.sort((key, tag, pay), num_keys=2)

    is_r = tag == 0
    boundary = jnp.concatenate([jnp.ones(1, bool), key[1:] != key[:-1]])
    idx = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, jnp.int32(-1)))
    r_flag = is_r.astype(jnp.int32)
    r_pref = jnp.cumsum(r_flag)
    # R rows sort before every S row of their key segment (tag 0 < 1), so
    # at an S position r_pref already counts the segment's full R run:
    # multiplicity = r_pref[pos] - r_pref just before the segment
    r_before_seg = jnp.where(seg_start > 0,
                             r_pref[jnp.maximum(seg_start - 1, 0)], 0)
    m = jnp.where(~is_r, r_pref - r_before_seg, 0)   # pairs this S row emits
    csum = jnp.cumsum(m)
    total = csum[-1]
    base = csum - m

    j = jnp.arange(out_cap, dtype=jnp.int32)
    i = jnp.searchsorted(csum, j, side="right").astype(jnp.int32)
    i = jnp.minimum(i, n - 1)
    t = j - base[i]
    src_r = jnp.minimum(seg_start[i] + t, n - 1)
    valid = j < total
    PAD = jnp.int32(-2147483648)
    out_r = jnp.where(valid, pay[src_r], PAD)
    out_s = jnp.where(valid, pay[i], PAD)
    out_k = jnp.where(valid, key[i], PAD)
    return total, out_r, out_s, out_k


def sort_scan_materialize_wide(r_khi, r_klo, r_phi, r_plo,
                               s_khi, s_klo, s_phi, s_plo):
    """Materialized KEY_8B join (unique 64-bit R keys).

    Returns (count, r_pay (hi, lo), s_pay (hi, lo), key (hi, lo)) —
    capacity-|S| columns with `count` valid rows, like
    sort_scan_materialize but over (hi, lo) pairs.
    """
    nr = r_klo.shape[0]
    ns = s_klo.shape[0]
    n = nr + ns
    flip = jnp.int32(-2147483648)
    khi = jnp.concatenate([r_khi, s_khi])
    klo = jnp.concatenate([r_klo, s_klo]) ^ flip
    tag = jnp.concatenate([jnp.zeros(nr, jnp.int32), jnp.ones(ns, jnp.int32)])
    phi = jnp.concatenate([r_phi, s_phi])
    plo = jnp.concatenate([r_plo, s_plo])
    khi, klo, tag, phi, plo = jax.lax.sort((khi, klo, tag, phi, plo),
                                           num_keys=3)

    is_r = tag == 0
    boundary = jnp.concatenate(
        [jnp.ones(1, bool), (khi[1:] != khi[:-1]) | (klo[1:] != klo[:-1])])
    idx = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, jnp.int32(-1)))
    r_flag = is_r.astype(jnp.int32)
    r_pref = jnp.cumsum(r_flag) - r_flag
    r_in_seg = r_pref - r_pref[seg_start]
    head_phi = phi[seg_start]
    head_plo = plo[seg_start]
    matched = (~is_r) & (r_in_seg == 1)
    count = jnp.sum(matched, dtype=jnp.int32)

    order = jnp.where(matched, idx, idx + n)
    PADI = jnp.int32(-2147483648)
    _, orh, orl, osh, osl, okh, okl = jax.lax.sort(
        (order,
         jnp.where(matched, head_phi, 0),
         jnp.where(matched, head_plo, 0),
         jnp.where(matched, phi, 0),
         jnp.where(matched, plo, 0),
         jnp.where(matched, khi, PADI),
         jnp.where(matched, klo ^ flip, PADI)), num_keys=1)
    return (count, (orh[:ns], orl[:ns]), (osh[:ns], osl[:ns]),
            (okh[:ns], okl[:ns]))
