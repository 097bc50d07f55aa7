"""run_join on every tier, exact against the native reference.

The file keeps its name from the bitmap-join engine whose tests these
replace; the workloads those tests used are cases of the parametrized
tests below."""

import numpy as np
import pytest

from hwbloomradixjoin.config import BloomArgs, BloomVariant, EngineConfig
from hwbloomradixjoin.data import generator as G
from hwbloomradixjoin.data import native
from hwbloomradixjoin.models import registry, run_join
from hwbloomradixjoin.types import KeyStats, Relation


def _workload(n_r=5000, n_s=40000, hi_mult=3, seed=0):
    rng = np.random.default_rng(seed)
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int32)
    sk = rng.integers(1, hi_mult * n_r, n_s).astype(np.int32)
    rp = np.arange(n_r, dtype=np.int32)
    sp = np.arange(n_s, dtype=np.int32)
    return rk, rp, sk, sp


# ---------------------------------------------------------------------------
# workloads the deleted partitioned kernels were tested on, now run through
# the planner's tiers: each returns (rk, rp, sk, sp, declared stats or None)
# ---------------------------------------------------------------------------

def _skewed():
    """One heavy S key next to a uniform tail."""
    rng = np.random.default_rng(13)
    rk, rp, _, _ = _workload(n_r=5000)
    sk = np.concatenate([np.full(60000, 7, np.int32),
                         rng.integers(1, 10000, 40000).astype(np.int32)])
    rng.shuffle(sk)
    sp = rng.integers(0, 1 << 30, sk.shape[0]).astype(np.int32)
    return rk, rp, sk, sp, KeyStats(1, 5000, is_unique=True)


def _deep_span():
    """Sparse R over a 2M-key range, most of S outside it."""
    rng = np.random.default_rng(7)
    lo, hi = 1, 1 << 21
    rk = rng.choice(np.arange(lo, hi + 1), 4000, replace=False)
    sk = np.concatenate([rng.choice(rk, 1500), rng.integers(lo, hi + 1, 1500),
                         rng.integers(hi + 1, 1 << 28, 27000)])
    rng.shuffle(sk)
    return (rk.astype(np.int32), np.arange(4000, dtype=np.int32),
            sk.astype(np.int32), np.arange(30000, dtype=np.int32), None)


def _full_range():
    """Unique R spread over [1, 2^31): wider than HT_MAX_SLOTS."""
    rng = np.random.default_rng(3)
    rk = np.unique(rng.integers(1, (1 << 31) - 1, 3100))[:3000]
    rng.shuffle(rk)
    sk = np.concatenate([rng.choice(rk, 2000),
                         rng.integers(1, (1 << 31) - 1, 20000)])
    rng.shuffle(sk)
    return (rk.astype(np.int32), np.arange(3000, dtype=np.int32),
            sk.astype(np.int32), np.arange(22000, dtype=np.int32),
            KeyStats(int(rk.min()), int(rk.max()), is_unique=True))


def _non_unique():
    """Duplicate R keys: every S match counts R's multiplicity."""
    rng = np.random.default_rng(7)
    rk = rng.integers(1, 4000, 6000).astype(np.int32)
    rp = rng.integers(0, 1 << 30, 6000).astype(np.int32)
    sk = rng.integers(1, 8000, 30000).astype(np.int32)
    sp = rng.integers(0, 1 << 30, 30000).astype(np.int32)
    return rk, rp, sk, sp, None


def _two_pass_sized():
    """The size at which the reference takes a second partition pass."""
    rk, rp, sk, sp = _workload(n_r=60000, n_s=120000, hi_mult=2, seed=3)
    return rk, rp, sk, sp, KeyStats(1, 60000, is_unique=True)


def _generated_fullrange():
    """The generator's --full-range population (non-unique R)."""
    p = G.WorkloadParams(r_size=3000, s_size=20000, nthreads=2,
                         fullrange_keys=True)
    return (*G.build_workload(p), None)


def _zipf():
    p = G.WorkloadParams(r_size=4000, s_size=30000, nthreads=2, skew=0.75)
    return (*G.build_workload(p), G.r_key_stats(p))


WORKLOADS = {"skewed": _skewed, "deep_span": _deep_span,
             "full_range": _full_range, "non_unique": _non_unique,
             "two_pass_sized": _two_pass_sized,
             "generated_fullrange": _generated_fullrange, "zipf": _zipf}


@pytest.mark.parametrize("algo", ["PRO", "PRH", "NPO"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_run_join_exact(workload, algo):
    rk, rp, sk, sp, stats = WORKLOADS[workload]()
    want = native.ref_join(rk, rp, sk, sp)
    R = Relation.from_numpy(rk, rp, stats=stats)
    S = Relation.from_numpy(sk, sp)
    res, st, (sr, ss) = run_join(algo, R, S, EngineConfig())
    span = int(rk.max()) - int(rk.min()) + 1
    wide = span > registry.HT_MAX_SLOTS
    assert st.tier == ("sortscan" if algo == "PRH" or wide else "ht")
    assert res.count() == want[0]
    assert sr == want[1] % 2**32 and ss == want[2] % 2**32


@pytest.mark.parametrize("variant", [BloomVariant.BLOCKED, BloomVariant.BASIC])
@pytest.mark.parametrize("workload", ["deep_span", "full_range", "skewed"])
def test_bloom_via_run_join_exact(workload, variant):
    """The bloom twin: exact join, and a survivor count equal to the
    bit-exact scalar filter's."""
    rk, rp, sk, sp, stats = WORKLOADS[workload]()
    args = BloomArgs(variant=variant, m=1 << 16, k=2, B=512)
    want = native.ref_join(rk, rp, sk, sp)
    want_after = int(native.ref_bloom(variant.value, args.m, args.k, args.B,
                                      args.seed, rk, sk).sum())
    R = Relation.from_numpy(rk, rp, stats=stats)
    S = Relation.from_numpy(sk, sp)
    res, st, (sr, ss) = run_join("PRO", R, S, EngineConfig(), args)
    assert res.count() == want[0]
    assert sr == want[1] % 2**32 and ss == want[2] % 2**32
    assert res.s_after_filter == want_after
    assert st.prune_usec > 0


@pytest.mark.parametrize("bloom", [False, True])
@pytest.mark.parametrize("unique", [True, False])
def test_materialized_pairs_exact(unique, bloom):
    """--materialize emits exactly the reference's pairs, as a multiset."""
    if unique:
        rk, rp, sk, sp = _workload(n_r=3000, n_s=20000, hi_mult=3, seed=13)
        stats = KeyStats(1, 3000, is_unique=True)
    else:
        rk, rp, sk, sp, stats = _non_unique()
        rk, sk = rk[:2000], sk[:6000]
        rp, sp = rp[:2000], sp[:6000]
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 16, k=2, B=512) \
        if bloom else None
    R = Relation.from_numpy(rk, rp, stats=stats)
    S = Relation.from_numpy(sk, sp)
    res, st, _ = run_join("PRO", R, S, EngineConfig(materialize=True), args)
    assert st.tier == "materialize"
    pays = {}
    for k, p in zip(rk.tolist(), rp.tolist()):
        pays.setdefault(k, []).append(p)
    want = sorted((r, s) for k, s in zip(sk.tolist(), sp.tolist())
                  for r in pays.get(k, []))
    n = res.count()
    got = sorted(zip(np.asarray(res.r_payload)[:n].tolist(),
                     np.asarray(res.s_payload)[:n].tolist()))
    assert n == len(want)
    assert got == want


def _relation(key8b=False, span=5000, unique=True):
    rk = np.arange(1, 101, dtype=np.int32)
    rk[-1] = span
    stats = KeyStats(1, span, is_unique=unique)
    return Relation.from_numpy(rk, rk, stats=stats, key8b=key8b)


@pytest.mark.parametrize("algo,rel,materialize,want", [
    ("PRO", dict(), False, "ht"),
    ("NPO", dict(), False, "ht"),
    ("PRHO", dict(), False, "ht"),
    ("PRH", dict(), False, "sortscan"),
    ("PRO", dict(span=registry.HT_MAX_SLOTS + 1), False, "sortscan"),
    ("PRO", dict(), True, "materialize"),
    ("PRO", dict(key8b=True), False, "key8b"),
    ("PRO", dict(key8b=True), True, "materialize8b"),
])
def test_select_tier_from_input(algo, rel, materialize, want):
    """The tier follows from tuple width, key span and materialization."""
    R = _relation(**rel)
    key_range = registry._key_range(R) if R.key_hi is None else None
    tier = registry.select_tier(registry.ALGORITHMS[algo], R,
                                EngineConfig(materialize=materialize),
                                key_range)
    assert tier == want


def test_key_range_declared_and_measured():
    R = _relation(span=777)
    assert registry._key_range(R) == (1, 777)
    rk = np.array([-5, 3, 40], np.int32)
    assert registry._key_range(Relation.from_numpy(rk)) == (-5, 40)
    assert registry._key_range(_relation(
        span=registry.HT_MAX_SLOTS + 1)) is None


def test_run_join_key8b():
    rk, rp, sk, sp = _workload()
    want = native.ref_join(rk, rp, sk, sp)
    R = Relation.from_numpy(rk, rp, key8b=True)
    S = Relation.from_numpy(sk, sp, key8b=True)
    assert R.key_hi is not None
    res, st, (sr, ss) = run_join("PRO", R, S, EngineConfig())
    assert st.tier == "key8b"
    assert res.count() == want[0]
    # KEY_8B widens value_t to int64 -> checksums accumulate mod 2^64
    assert sr == want[1] % 2**64 and ss == want[2] % 2**64


def test_run_join_materialize():
    rk, rp, sk, sp = _workload(n_r=2000, n_s=8000, hi_mult=2)
    R = Relation.from_numpy(rk, rp)
    S = Relation.from_numpy(sk, sp)
    res, st, _ = run_join("PRO", R, S, EngineConfig(materialize=True))
    assert st.tier == "materialize"
    pairs_native = native.ref_join(rk, rp, sk, sp)
    assert res.count() == pairs_native[0]
    # materialized pairs match ground truth as a multiset
    rpay = np.asarray(res.r_payload)[:res.count()]
    spay = np.asarray(res.s_payload)[:res.count()]
    got = sorted(zip(rpay.tolist(), spay.tolist()))
    # ground truth via dict (unique R keys)
    rmap = {int(k): int(p) for k, p in zip(rk, rp)}
    want_pairs = sorted((rmap[int(k)], int(p))
                        for k, p in zip(sk, sp) if int(k) in rmap)
    assert got == want_pairs


def test_run_join_ht_tier_phases():
    rk, rp, sk, sp = _workload()
    want = native.ref_join(rk, rp, sk, sp)
    R = Relation.from_numpy(rk, rp)
    S = Relation.from_numpy(sk, sp)
    res, st, (sr, ss) = run_join("NPO", R, S, EngineConfig())
    assert st.tier == "ht"
    assert res.count() == want[0]
    assert st.build_usec > 0 and st.probe_usec > 0
    assert sr == want[1] % 2**32


def test_run_join_sortscan_part_phase():
    rk, rp, sk, sp = _workload()
    want = native.ref_join(rk, rp, sk, sp)
    R = Relation.from_numpy(rk, rp)
    S = Relation.from_numpy(sk, sp)
    res, st, _ = run_join("PRH", R, S, EngineConfig())
    assert st.tier == "sortscan"
    assert res.count() == want[0]
    assert st.part_usec > 0 and st.probe_usec > 0


def test_key8b_bloom_low_word_truncation():
    """--key8b + bloom: the filter sees the LOW key word (the reference's
    uint32 filter API truncates int64 keys)."""
    rk, rp, sk, sp = _workload(n_r=3000, n_s=12000, hi_mult=2)
    want, _, _ = native.ref_join(rk, rp, sk, sp)
    R = Relation.from_numpy(rk, rp, key8b=True)
    S = Relation.from_numpy(sk, sp, key8b=True)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 16, k=2, B=512)
    res, st, _ = run_join("PRO", R, S, EngineConfig(), args)
    assert st.tier == "key8b"
    assert res.count() == want            # no false negatives ever
    assert res.s_after_filter is not None
    assert want <= res.s_after_filter <= len(sk)


def test_key8b_wide_payload_checksums():
    """KEY_8B with payloads > 2^31: 64-bit checksum parity (mod 2^64)."""
    rng = np.random.default_rng(21)
    n_r, n_s = 2000, 9000
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int64)
    sk = rng.integers(1, 2 * n_r, n_s).astype(np.int64)
    rp = rng.integers(2**31, 2**40, n_r).astype(np.int64)
    sp = rng.integers(2**31, 2**40, n_s).astype(np.int64)
    # numpy ground truth mod 2^64
    match = np.isin(sk, rk)
    pay_of = dict(zip(rk.tolist(), rp.tolist()))
    want_sr = sum(pay_of[k] for k in sk[match].tolist()) % 2**64
    want_ss = int(sp[match].astype(np.uint64).sum(dtype=np.uint64))
    R = Relation.from_numpy(rk, rp, key8b=True)
    S = Relation.from_numpy(sk, sp, key8b=True)
    res, st, (sr, ss) = run_join("PRO", R, S, EngineConfig())
    assert st.tier == "key8b"
    assert res.count() == int(match.sum())
    assert sr == want_sr
    assert ss == want_ss


def test_key8b_materialize():
    """KEY_8B + materialize: 64-bit rid pairs."""
    rng = np.random.default_rng(22)
    n_r, n_s = 800, 3000
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int64)
    sk = rng.integers(1, 2 * n_r, n_s).astype(np.int64)
    rp = rng.integers(2**31, 2**40, n_r).astype(np.int64)
    sp = rng.integers(2**31, 2**40, n_s).astype(np.int64)
    R = Relation.from_numpy(rk, rp, key8b=True)
    S = Relation.from_numpy(sk, sp, key8b=True)
    res, st, _ = run_join("PRO", R, S, EngineConfig(materialize=True))
    assert st.tier == "materialize8b"
    match = np.isin(sk, rk)
    n = res.count()
    assert n == int(match.sum())
    pay_of = dict(zip(rk.tolist(), rp.tolist()))
    got = sorted(zip(np.asarray(res.r_payload)[:n].tolist(),
                     np.asarray(res.s_payload)[:n].tolist()))
    want = sorted((pay_of[k], p)
                  for k, p in zip(sk[match].tolist(), sp[match].tolist()))
    assert got == want


@pytest.mark.parametrize("workload", ["deep_span", "non_unique"])
def test_key8b_exact_on_wide_tier(workload):
    """key8b over the workloads above: 64-bit sort tier, sums mod 2^64."""
    rk, rp, sk, sp, _ = WORKLOADS[workload]()
    want = native.ref_join(rk, rp, sk, sp)
    R = Relation.from_numpy(rk, rp, key8b=True)
    S = Relation.from_numpy(sk, sp, key8b=True)
    res, st, (sr, ss) = run_join("PRO", R, S, EngineConfig())
    assert st.tier == "key8b"
    assert res.count() == want[0]
    assert sr == want[1] % 2**64 and ss == want[2] % 2**64
