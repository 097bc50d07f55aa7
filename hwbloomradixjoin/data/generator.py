"""Deterministic relation generators reproducing the reference key populations.

The reference builds workloads with four generator families (src/generator.c,
src/genzipf.c); this module reproduces each one's key multiset exactly:

1. ``parallel_create_relation`` (generator.c:304-415): per-thread sequential
   key ranges with a selectivity threshold scheme — sel*n keys cycle in
   [1, threshold], the rest cycle in (threshold, INT_MAX]
   (random_unique_gen_thread, generator.c:161-221).  The per-thread slice
   sizes follow the reference's page-granular split, so the multiset is
   byte-identical for a given (n, nthreads, maxid, threshold, selectivity).
   The reference then shuffles KEYS ONLY with a time-seeded parallel Knuth
   pass (generator.c:199-218) — order is non-deterministic there, so here the
   permutation is a seeded PRNG (documented equivalence: multiset-exact,
   order-randomized).

2. ``create_relation_zipf`` (generator.c:658-676 -> genzipf.c): bit-exact via
   the native glibc-rand stream (validated against the reference binary).

3. ``create_relation_nonunique`` / ``create_relation_nonunique_from_pk``
   (generator.c:584-646): rand()-driven, bit-exact via native lib.

4. ``create_relation_fk_from_pk`` (generator.c:530-582): PK tiling + uniform
   non-matching tail + key shuffle, bit-exact via native lib.

The driver-level wiring (which generator, with which maxid/threshold) mirrors
src/main.c:416-467.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from hwbloomradixjoin.data import native

INT_MAX = 2147483647
PAGE_SIZE = 4096


def _cycle_keys_below(first: int, count: int, threshold: int) -> np.ndarray:
    """Key sequence starting at `first`, stepping +1, wrapping threshold -> 1.

    first may be 0 (when (offset+1) % threshold == 0), in which case 0 is
    emitted once and the cycle continues from 1 — matching the reference's
    post-emit wrap test (generator.c:184-188).
    """
    if count <= 0:
        return np.empty(0, dtype=np.int64)
    idx = np.arange(count, dtype=np.int64)
    if first == 0:
        out = np.empty(count, dtype=np.int64)
        out[0] = 0
        out[1:] = (idx[: count - 1] % threshold) + 1
        return out
    return ((first - 1 + idx) % threshold) + 1


def _cycle_keys_above(first: int, count: int, threshold: int, maxid: int) -> np.ndarray:
    """Above-threshold keys: start at `first`, wrap INT_MAX -> threshold+1."""
    if count <= 0:
        return np.empty(0, dtype=np.int64)
    span = INT_MAX - threshold  # cycle [threshold+1, INT_MAX]
    idx = np.arange(count, dtype=np.int64)
    if first == threshold:  # (offset_above+1) % range == 0 edge
        out = np.empty(count, dtype=np.int64)
        out[0] = threshold
        out[1:] = threshold + ((idx[: count - 1]) % span) + 1
        return out
    return threshold + ((first - threshold - 1 + idx) % span) + 1


def parallel_create_relation(num_tuples: int, nthreads: int, maxid: int,
                             threshold: int, selectivity: float,
                             shuffle_seed: int | None = None,
                             tuple_bytes: int = 8):
    """Multiset-exact reproduction of the reference parallel PK generator.

    Returns (keys, payloads) as int32 arrays.  payload = original rid (the
    reference shuffles keys only, so payloads stay 0..n-1 in slot order).
    """
    n = int(num_tuples)
    npages = (n * tuple_bytes) // PAGE_SIZE + 1
    npages_perthr = npages // nthreads
    ntuples_perthr = npages_perthr * (PAGE_SIZE // tuple_bytes)
    ntuples_above = int(n * (1.0 - selectivity))
    if npages_perthr == 0:
        ntuples_perthr = n // nthreads
    ntuples_above_perthr = int(ntuples_perthr * (1.0 - selectivity))
    ntuples_lastthr = n - ntuples_perthr * (nthreads - 1)
    ntuples_above_lastthr = ntuples_above - (nthreads - 1) * ntuples_above_perthr

    keys = np.empty(n, dtype=np.int64)
    offset = 0
    offset_above = 0
    for t in range(nthreads):
        firstkey = (offset + 1) % threshold
        firstkey_above = threshold + (offset_above + 1) % max(1, maxid - threshold)
        nt = ntuples_lastthr if t == nthreads - 1 else ntuples_perthr
        na = ntuples_above_lastthr if t == nthreads - 1 else ntuples_above_perthr
        nb = nt - na
        start = offset + offset_above
        keys[start:start + nb] = _cycle_keys_below(firstkey, nb, threshold)
        keys[start + nb:start + nt] = _cycle_keys_above(
            firstkey_above, na, threshold, maxid)
        offset += ntuples_perthr - ntuples_above_perthr
        offset_above += ntuples_above_perthr

    keys = keys.astype(np.int32)
    payloads = np.arange(n, dtype=np.int32)
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        keys = keys[rng.permutation(n)]
    return keys, payloads


def create_relation_zipf(seed: int, num_tuples: int, maxid: int,
                         zipf_param: float):
    """Zipf-distributed keys over a permuted alphabet 1..maxid (bit-exact)."""
    keys = native.gen_zipf(seed, num_tuples, maxid, zipf_param)
    return keys, np.arange(num_tuples, dtype=np.int32)


def create_relation_nonunique(seed: int, num_tuples: int, maxid: int):
    keys = native.random_gen(seed, num_tuples, 0, maxid)
    return keys, np.arange(num_tuples, dtype=np.int32)


def create_relation_nonunique_from_pk(seed: int, pk_keys: np.ndarray,
                                      num_tuples: int, threshold: int,
                                      selectivity: float):
    keys = native.nonunique_from_pk(seed, pk_keys, num_tuples, threshold,
                                    selectivity)
    return keys, np.arange(num_tuples, dtype=np.int32)


def create_relation_fk_from_pk(seed: int, pk_keys: np.ndarray,
                               pk_pays: np.ndarray, num_tuples: int,
                               threshold: int, selectivity: float):
    return native.fk_from_pk(seed, pk_keys, pk_pays, num_tuples, threshold,
                             selectivity)


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    """Relation-construction parameters, mirroring param_t (src/main.c)."""

    r_size: int = 128_000_000
    s_size: int = 128_000_000
    r_seed: int = 12345
    s_seed: int = 54321
    nthreads: int = 2
    skew: float = 0.0
    selectivity: float = 1.0
    nonunique_keys: bool = False
    fullrange_keys: bool = False
    key8b: bool = False


def build_workload(p: WorkloadParams):
    """Build (R_keys, R_pays, S_keys, S_pays) exactly as main.c:416-467 does.

    - default: R = parallel PK over [1, r_size]; S = parallel FK with
      selectivity threshold r_size (uniform) or Zipf over [1, r_size] (skew>0)
    - --full-range: R non-unique over [0, ceil(INT_MAX*sel)], S = fk_from_pk
    - --non-unique: R non-unique over [0, min(r_size, ceil(INT_MAX*sel))],
      S = nonunique_from_pk
    """
    tb = 16 if p.key8b else 8
    if p.fullrange_keys:
        threshold = math.ceil(INT_MAX * p.selectivity)
        rk, rp = create_relation_nonunique(p.r_seed, p.r_size, threshold)
        sk, sp = create_relation_fk_from_pk(p.s_seed, rk, rp, p.s_size,
                                            threshold, p.selectivity)
    elif p.nonunique_keys:
        threshold = min(p.r_size, math.ceil(INT_MAX * p.selectivity))
        rk, rp = create_relation_nonunique(p.r_seed, p.r_size, threshold)
        sk, sp = create_relation_nonunique_from_pk(p.s_seed, rk, p.s_size,
                                                   threshold, p.selectivity)
    else:
        rk, rp = parallel_create_relation(p.r_size, p.nthreads, p.r_size,
                                          p.r_size, 1.0,
                                          shuffle_seed=p.r_seed, tuple_bytes=tb)
        if p.skew > 0:
            sk, sp = create_relation_zipf(p.s_seed, p.s_size, p.r_size, p.skew)
        else:
            sk, sp = parallel_create_relation(p.s_size, p.nthreads, INT_MAX,
                                              p.r_size, p.selectivity,
                                              shuffle_seed=p.s_seed,
                                              tuple_bytes=tb)
    return rk, rp, sk, sp


def r_key_stats(p: WorkloadParams):
    """Declared build-side key constraints for a generated workload.

    The default PK generator emits exactly one of each key in [1, r_size]
    (selectivity 1.0 path), so R is a unique key over [1, r_size].
    Non-unique / full-range workloads get no constraint.
    """
    from hwbloomradixjoin.types import KeyStats

    if p.fullrange_keys or p.nonunique_keys:
        return None
    return KeyStats(min_key=1, max_key=p.r_size, is_unique=True)


def expected_uniform_match_count(s_size: int, selectivity: float) -> int:
    """Exact match count for the uniform PK/FK workload: n - floor(n*(1-q)).

    Every below-threshold S key cycles in [1, r_size] = R's key set, and the
    per-thread above-counts sum exactly to floor(n*(1-q)) (generator.c math),
    independent of nthreads.
    """
    return s_size - int(s_size * (1.0 - selectivity))
