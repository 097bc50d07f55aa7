"""Bloom filter exactness: native vs jnp math vs reference FPR goldens.

The small-scale golden values below were produced by the reference binary:
    ./unittests 2 817263 1000000 131072 1048576 6
(m=2^20, 131072 inserts, 1e6 probes over disjoint key ranges, k=1..6) —
the same protocol as the committed full-scale table
measurements/data/bloom_filter_fpr.txt (m=2^30, n=128M, |S|=1.024B).
"""

import numpy as np
import pytest

from hwbloomradixjoin.config import BloomArgs, BloomVariant
from hwbloomradixjoin.data import native
from hwbloomradixjoin.ops import bloom

SEED = 817263
M = 1 << 20
N_INS = 131072
N_SAMPLES = 1_000_000

# fpr_emp ("%.3f%%") from the reference unittests run above
GOLDEN_FPR = {
    ("blocked", 1): 11.778, ("blocked", 2): 4.940, ("blocked", 3): 3.175,
    ("blocked", 4): 2.530, ("blocked", 5): 2.334, ("blocked", 6): 2.366,
    ("basic", 1): 11.721, ("basic", 2): 4.882, ("basic", 3): 3.046,
    ("basic", 4): 2.383, ("basic", 5): 2.184, ("basic", 6): 2.165,
}


@pytest.fixture(scope="module")
def keysets():
    # test_bloom_fpr_wrapper: srand(seed+1); R from [0, threshold),
    # S from [threshold+1, INT32_MAX), one continuous rand() stream.
    threshold = int(2147483647 * (N_INS / (N_INS + N_SAMPLES)))
    r, consumed = native.unique_gen_range(SEED + 1, 0, N_INS, 0, threshold)
    s, _ = native.unique_gen_range(SEED + 1, consumed, N_SAMPLES,
                                   threshold + 1, 2147483647)
    # filter seed: srand(seed); rand()
    fseed = int(native.rand_stream(SEED, 1)[0])
    return r, s, fseed


@pytest.mark.parametrize("variant", ["blocked", "basic"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_fpr_matches_reference(keysets, variant, k):
    r, s, fseed = keysets
    contains = native.ref_bloom(variant, M, k, 512, fseed, r, s)
    fpr = contains.sum() / N_SAMPLES * 100.0
    assert round(fpr, 3) == GOLDEN_FPR[(variant, k)], (variant, k, fpr)


@pytest.mark.parametrize("variant", [BloomVariant.BASIC, BloomVariant.BLOCKED])
def test_host_math_matches_native(variant):
    """jnp/numpy position math == native scalar filter, bit for bit."""
    rng = np.random.default_rng(7)
    add = rng.integers(-2**31, 2**31, 20_000, dtype=np.int32)
    query = np.concatenate([add[:5000],
                            rng.integers(-2**31, 2**31, 20_000, dtype=np.int32)])
    args = BloomArgs(variant=variant, m=1 << 16, k=3, B=512, seed=42)
    vname = variant.value
    want_mask, want_bitmap = native.ref_bloom(vname, args.m, args.k, args.B,
                                              args.seed, add, query,
                                              want_bitmap=True)
    got_bitmap = bloom.build_bitmap_host(add, args)
    assert np.array_equal(got_bitmap, want_bitmap.view(np.uint32))
    got_mask = bloom.probe_bitmap_host(got_bitmap, query, args)
    assert np.array_equal(got_mask, want_mask)
    # every added key must be contained (no false negatives, ever)
    assert bloom.probe_bitmap_host(got_bitmap, add, args).all()


def test_theoretical_fpr():
    # golden table rows (m=2^30, n=128M): k=1 -> 11.238%, k=6 -> 1.779%
    assert round(bloom.theoretical_fpr(1 << 30, 1, 128_000_000) * 100, 3) == 11.238
    assert round(bloom.theoretical_fpr(1 << 30, 6, 128_000_000) * 100, 3) == 1.779
