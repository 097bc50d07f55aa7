"""Join algorithm correctness: every registered algorithm vs ground truth."""

import numpy as np
import pytest

from hwbloomradixjoin.config import BloomArgs, BloomVariant, EngineConfig
from hwbloomradixjoin.data import generator as G
from hwbloomradixjoin.data import native
from hwbloomradixjoin.models import ALGORITHMS, run_join
from hwbloomradixjoin.types import Relation

CFG = EngineConfig()


@pytest.fixture(scope="module")
def workload():
    p = G.WorkloadParams(r_size=20_000, s_size=100_000, nthreads=4,
                         selectivity=0.3)
    rk, rp, sk, sp = G.build_workload(p)
    want = native.ref_join(rk, rp, sk, sp)
    return (Relation.from_numpy(rk, rp), Relation.from_numpy(sk, sp), want)


@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_algo_exact_count(workload, algo):
    R, S, want = workload
    result, stats, (sr, ss) = run_join(algo, R, S, CFG)
    assert result.count() == want[0] == G.expected_uniform_match_count(100_000, 0.3)
    assert sr == want[1] % 2**32
    assert ss == want[2] % 2**32


@pytest.mark.parametrize("algo", ["PRO", "RJ", "PRH", "PRHO"])
@pytest.mark.parametrize("variant", [BloomVariant.BASIC, BloomVariant.BLOCKED])
def test_bloom_twin_exact_count_and_prune(workload, algo, variant):
    R, S, want = workload
    args = BloomArgs(variant=variant, m=1 << 18, k=2, B=512)
    result, stats, (sr, ss) = run_join(algo, R, S, CFG, args)
    assert result.count() == want[0]
    assert sr == want[1] % 2**32 and ss == want[2] % 2**32
    # prune: survivors >= true matches; FP rate sane vs theoretical model
    assert stats.s_after_filter is not None
    true_matches = want[0]
    negatives = 100_000 - true_matches
    fp = stats.s_after_filter - true_matches
    assert fp >= 0
    from hwbloomradixjoin.ops import bloom as B
    theo = B.theoretical_fpr(1 << 18, 2, 20_000)
    assert fp / negatives < max(3 * theo, 0.02)


def test_npo_ignores_bloom(workload):
    # B_NPO wrappers ignore the filter (main.c:296-312)
    R, S, want = workload
    args = BloomArgs(variant=BloomVariant.BASIC, m=1 << 18, k=2)
    result, stats, _ = run_join("NPO", R, S, CFG, args)
    assert result.count() == want[0]
    assert stats.s_after_filter is None


def test_zipf_workload_all_algos():
    p = G.WorkloadParams(r_size=5_000, s_size=40_000, nthreads=2, skew=1.0)
    rk, rp, sk, sp = G.build_workload(p)
    want = native.ref_join(rk, rp, sk, sp)
    assert want[0] == 40_000  # zipf alphabet ⊆ R keys: every S tuple matches
    R, S = Relation.from_numpy(rk, rp), Relation.from_numpy(sk, sp)
    for algo in ("PRO", "NPO"):
        result, _, (sr, ss) = run_join(algo, R, S, CFG)
        assert result.count() == 40_000
        assert sr == want[1] % 2**32 and ss == want[2] % 2**32


def test_nonunique_duplicates():
    p = G.WorkloadParams(r_size=3_000, s_size=20_000, nthreads=2,
                         selectivity=0.5, nonunique_keys=True)
    rk, rp, sk, sp = G.build_workload(p)
    want = native.ref_join(rk, rp, sk, sp)
    R, S = Relation.from_numpy(rk, rp), Relation.from_numpy(sk, sp)
    for algo in ("PRO", "NPO"):
        result, _, _ = run_join(algo, R, S, CFG)
        assert result.count() == want[0], algo
