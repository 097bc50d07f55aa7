"""Generator parity vs relations persisted by the reference binary.

Fixture tests/fixtures/relations_golden.npz holds R/S dumps (PERSIST_RELATIONS)
from the reference mchashjoins for four configs:

- tiny:      -r 37 -s 101 -n 3 -q 0.7          (uniform threshold scheme)
- odd:       -r 12345 -s 54321 -n 7 -q 0.999   (uniform, odd split)
- nonuniq:   -r 10000 -s 40000 -n 2 --non-unique -q 0.5   (Results = 40256)
- fullrange: -r 10000 -s 40000 -n 2 --full-range -q 0.001 (Results = 40)

Uniform relations are compared as key multisets (the reference's key shuffle
is time-seeded and order-nondeterministic); rand()-driven generators are
compared in exact order.
"""

import math
import os

import numpy as np
import pytest

from hwbloomradixjoin.data import generator as G
from hwbloomradixjoin.data import native, tblio

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "relations_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


def test_glibc_rand_first_values():
    # glibc rand() with seed 1: well-known leading values
    got = native.rand_stream(1, 4)
    assert list(got) == [1804289383, 846930886, 1681692777, 1714636915]
    # seed 0 behaves as seed 1
    assert list(native.rand_stream(0, 4)) == list(native.rand_stream(1, 4))


def test_uniform_pk_tiny(golden):
    rk, _ = G.parallel_create_relation(37, 3, 37, 37, 1.0)
    assert np.array_equal(np.sort(rk), np.sort(golden["tiny_rk"]))
    sk, _ = G.parallel_create_relation(101, 3, G.INT_MAX, 37, 0.7)
    assert np.array_equal(np.sort(sk), np.sort(golden["tiny_sk"]))


def test_uniform_pk_odd_sizes(golden):
    rk, _ = G.parallel_create_relation(12345, 7, 12345, 12345, 1.0)
    assert np.array_equal(np.sort(rk), np.sort(golden["odd_rk"]))
    sk, _ = G.parallel_create_relation(54321, 7, G.INT_MAX, 12345, 0.999)
    assert np.array_equal(np.sort(sk), np.sort(golden["odd_sk"]))


def test_uniform_r_is_exact_permutation():
    rk, rp = G.parallel_create_relation(100_000, 4, 100_000, 100_000, 1.0)
    assert np.array_equal(np.sort(rk), np.arange(1, 100_001))
    assert np.array_equal(rp, np.arange(100_000, dtype=np.int32))


def test_nonunique_exact_order(golden):
    thr = min(10000, math.ceil(G.INT_MAX * 0.5))
    rk, rp = G.create_relation_nonunique(12345, 10000, thr)
    assert np.array_equal(rk, golden["nonuniq_rk"])
    sk, sp = G.create_relation_nonunique_from_pk(54321, rk, 40000, thr, 0.5)
    assert np.array_equal(sk, golden["nonuniq_sk"])
    cnt, _, _ = native.ref_join(rk, rp, sk, sp)
    assert cnt == 40256  # printed by the reference run


def test_fullrange_fk_from_pk_exact(golden):
    thr = math.ceil(G.INT_MAX * 0.001)
    rk, rp = G.create_relation_nonunique(12345, 10000, thr)
    assert np.array_equal(rk, golden["fullrange_rk"])
    sk, sp = G.create_relation_fk_from_pk(54321, rk, rp, 40000, thr, 0.001)
    assert np.array_equal(sk, golden["fullrange_sk"])
    assert np.array_equal(sp, golden["fullrange_sp"])
    cnt, _, _ = native.ref_join(rk, rp, sk, sp)
    assert cnt == 40


def test_zipf_bit_exact_vs_reference():
    """create_relation_zipf is BIT-EXACT (same order) vs the reference.

    Goldens dumped from a /tmp build of the reference's seed_generator +
    create_relation_zipf (src/generator.c:658-676, src/genzipf.c:97-158)
    for three (seed, n, maxid, z) configs -> tests/fixtures/zipf_golden.npz.
    """
    import os
    gold = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "zipf_golden.npz"))
    for seed, n, maxid, z in [(54321, 200_000, 1000, 1.0),
                              (54321, 100_000, 4096, 0.75),
                              (12345, 50_000, 65536, 1.25)]:
        keys, pays = G.create_relation_zipf(seed, n, maxid, z)
        want = gold[f"zipf_{seed}_{n}_{maxid}_{z}"]
        assert np.array_equal(np.asarray(keys, np.int32), want)
        assert np.array_equal(pays, np.arange(n, dtype=np.int32))


def test_expected_match_count_formula(golden):
    assert G.expected_uniform_match_count(400_000, 0.25) == 100_000
    assert G.expected_uniform_match_count(54321, 0.999) == 54267  # ref printed


def test_build_workload_uniform():
    p = G.WorkloadParams(r_size=1000, s_size=8000, nthreads=2, selectivity=0.5)
    rk, rp, sk, sp = G.build_workload(p)
    cnt, _, _ = native.ref_join(rk, rp, sk, sp)
    assert cnt == G.expected_uniform_match_count(8000, 0.5)


def test_build_workload_zipf_all_match():
    p = G.WorkloadParams(r_size=500, s_size=4000, nthreads=2, skew=1.0)
    rk, rp, sk, sp = G.build_workload(p)
    cnt, _, _ = native.ref_join(rk, rp, sk, sp)
    assert cnt == 4000  # zipf alphabet [1, r_size] is a subset of R's keys


def test_tblio_roundtrip(tmp_path):
    keys = np.array([1, -5, 2147483647, 0], dtype=np.int32)
    pays = np.array([10, 20, 30, 40], dtype=np.int32)
    path = str(tmp_path / "x.tbl")
    tblio.write_relation(path, keys, pays)
    k2, p2 = tblio.read_relation(path)
    assert np.array_equal(keys, k2) and np.array_equal(pays, p2)
    with open(path) as f:
        assert f.readline() == "#KEY, VAL\n"
