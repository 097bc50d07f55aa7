"""Aggregate, sort, and materialization operator tests."""

import jax
import numpy as np
import pytest

from hwbloomradixjoin.ops import aggregate, sort, xla_join


def test_group_by_key():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 50, 2000).astype(np.int32)
    vals = rng.integers(0, 1000, 2000).astype(np.int32)
    uk, uc, us, ng = aggregate.group_by_key(keys, vals)
    uk, uc, us, ng = map(np.asarray, (uk, uc, us, int(ng)))
    want_keys, want_counts = np.unique(keys, return_counts=True)
    assert ng == len(want_keys)
    assert np.array_equal(np.sort(uk[:ng]), want_keys)
    order = np.argsort(uk[:ng])
    assert np.array_equal(uc[:ng][order], want_counts)
    want_sums = np.array([vals[keys == k].astype(np.uint32).sum(dtype=np.uint64) % 2**32
                          for k in want_keys], dtype=np.uint32)
    assert np.array_equal(us[:ng][order], want_sums)


def test_join_group_count():
    rng = np.random.default_rng(12)
    rk = rng.integers(0, 30, 200).astype(np.int32)
    sk = rng.integers(0, 40, 1000).astype(np.int32)
    keys, counts, ng = aggregate.join_group_count(rk, sk)
    keys, counts, ng = np.asarray(keys), np.asarray(counts), int(ng)
    want = {}
    for k in np.intersect1d(rk, sk):
        want[k] = (rk == k).sum() * (sk == k).sum()
    assert ng == len(want)
    got = dict(zip(keys[:ng].tolist(), counts[:ng].tolist()))
    assert got == {int(k): int(v) for k, v in want.items()}
    # aggregate totals == join count
    assert counts[:ng].sum() == sum(want.values())


def test_radix_sort():
    rng = np.random.default_rng(13)
    keys = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    pays = np.arange(5000, dtype=np.int32)
    ks, ps = sort.radix_sort(keys, pays)
    ks, ps = np.asarray(ks), np.asarray(ps)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(ks, keys[order])
    assert np.array_equal(ps, pays[order])


def test_materialize_unique_build():
    rng = np.random.default_rng(14)
    nr, ns = 500, 3000
    rk = rng.permutation(np.arange(1, nr + 1)).astype(np.int32)
    rp = rng.integers(0, 10**6, nr).astype(np.int32)
    sk = rng.integers(1, 3 * nr, ns).astype(np.int32)
    sp = rng.integers(0, 10**6, ns).astype(np.int32)
    cnt, out_r, out_s, out_k = xla_join.sort_scan_materialize(rk, rp, sk, sp)
    cnt = int(cnt)
    out_r, out_s, out_k = map(np.asarray, (out_r, out_s, out_k))
    # ground truth pairs
    rmap = dict(zip(rk.tolist(), rp.tolist()))
    want = sorted((int(k), rmap[int(k)], int(p))
                  for k, p in zip(sk, sp) if int(k) in rmap)
    assert cnt == len(want)
    got = sorted(zip(out_k[:cnt].tolist(), out_r[:cnt].tolist(),
                     out_s[:cnt].tolist()))
    assert got == want


@pytest.mark.parametrize("bits", [0, 1, 4, 8])
def test_radix_cluster_operator(bits):
    """Bucket runs in MSB order, stable within a bucket, starts exact,
    out-of-range keys after the last bucket; payloads follow their keys."""
    rng = np.random.default_rng(11)
    lo, hi = 100, 100 + (1 << 16) - 1
    keys = rng.integers(lo - 500, hi + 500, 40000).astype(np.int32)
    pays = np.arange(40000, dtype=np.int32)
    out_k, out_p, starts = jax.jit(
        lambda k, p: sort.radix_cluster(k, lo, hi, bits, p))(keys, pays)
    out_k, out_p, starts = map(np.asarray, (out_k, out_p, starts))
    inside = (keys >= lo) & (keys <= hi)
    bucket = np.where(inside, (keys.astype(np.int64) - lo) >> (16 - bits),
                      1 << bits)
    order = np.argsort(bucket, kind="stable")
    assert np.array_equal(out_k, keys[order])
    assert np.array_equal(out_p, pays[order])
    want_starts = np.searchsorted(bucket[order], np.arange((1 << bits) + 1))
    assert np.array_equal(starts, want_starts)
    assert starts[-1] == int(inside.sum())
