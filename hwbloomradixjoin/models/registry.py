"""Algorithm registry and the join driver.

Mirrors the reference's algos[] table (src/main.c:331-339): six algorithm
names, each with a plain and a bloom entry point (NPO/NPO_st ignore the
filter exactly as the reference's B_NPO wrappers do, main.c:296-312).

Every algorithm runs on one of a few XLA tiers.  `select_tier` picks one
from properties of the input alone — tuple width, key span, and whether
pairs are materialized:

  ht             perfect-addressed count table over R's key range: one
                 scatter-add build, one gather per S tuple, both checksums
                 (ops/ht_join.py).  PRO, RJ, PRHO, NPO and NPO_st whenever
                 the span fits HT_MAX_SLOTS; duplicate R keys are counted.
  sortscan       sort of R ∪ S plus a segmented scan (ops/xla_join.py).
                 PRH — the reference's histogram re-order carried to a
                 total order — and any algorithm whose key span exceeds
                 HT_MAX_SLOTS (e.g. --full-range).
  key8b          the sort tier over (hi, lo) key columns (16-byte tuples,
                 checksums mod 2^64).
  materialize,   pair-emitting sort tiers (--materialize), unique or
  materialize8b  non-unique build side.

The bloom twins prune S with the XLA filter (ops/bloom.py) inside the same
program, before the tier's own work; pruned S slots become PAD_KEY.

Timing: the whole join (prune, build, partition, probe) is one compiled
program.  The reported total is the mean of a warmed loop of that program
that ends in a host readback — the reference's TOTAL-TIME-USECS span
(parallel_radix_join_bloom.c:1509-1547).  Phase times come from running each
phase as a program of its own, warmed, to block_until_ready.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hwbloomradixjoin.config import BloomArgs, EngineConfig
from hwbloomradixjoin.models import bloom_join
from hwbloomradixjoin.ops import ht_join, xla_join
from hwbloomradixjoin.types import JoinResult, Relation
from hwbloomradixjoin.utils.timing import JoinStats

# Key-span budget of the count-table tier: two 4-byte tables (count and
# payload sum) per slot, so 2^28 slots take 2 GiB of device memory.  Wider
# spans go to the sort tier.
HT_MAX_SLOTS = 1 << 28

PAD = Relation.PAD_KEY


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    name: str
    family: str            # "radix" | "npo" (the npo bloom twin ignores
                           # the filter)


ALGORITHMS = {
    "PRO": AlgoSpec("PRO", "radix"),
    "RJ": AlgoSpec("RJ", "radix"),
    "PRH": AlgoSpec("PRH", "radix"),
    "PRHO": AlgoSpec("PRHO", "radix"),
    "NPO": AlgoSpec("NPO", "npo"),
    "NPO_st": AlgoSpec("NPO_st", "npo"),
}


def _key_range(R: Relation):
    """Static key range for the count-table tier; None if it is too wide.

    Uses declared stats when present; otherwise a one-off device min/max
    (planning-time metadata collection, not in the timed path).
    """
    if R.stats is not None:
        lo, hi = int(R.stats.min_key), int(R.stats.max_key)
    else:
        lo = int(jnp.min(R.key))
        hi = int(jnp.max(R.key))
    if hi - lo + 1 > HT_MAX_SLOTS or lo < -(1 << 30):
        return None
    return lo, hi


def select_tier(spec: AlgoSpec, R: Relation, cfg: EngineConfig,
                key_range) -> str:
    """Pick the execution tier for this (algorithm, input, config)."""
    if R.key_hi is not None:
        return "materialize8b" if cfg.materialize else "key8b"
    if cfg.materialize:
        return "materialize"
    if spec.name == "PRH" or key_range is None:
        return "sortscan"
    return "ht"


def _prune_fn(bloom_args: BloomArgs):
    """(rk, rkh, rp, sk, skh, sp) -> (pruned args, surviving S count)."""
    def prune(rk, rkh, rp, sk, skh, sp):
        # under --key8b the reference's uint32 filter API sees the low key
        # word only (hash.h:10 vs types.h:22-28); pruning on the lo column
        # reproduces that, truncation-collision false positives included
        mask, s_after = bloom_join.bloom_prune(rk, sk, bloom_args)
        sk = jnp.where(mask, sk, PAD)
        if skh.shape[0]:
            # pruned rows become the reserved (PAD, PAD) key pair
            skh = jnp.where(mask, skh, PAD)
        return (rk, rkh, rp, sk, skh, sp), s_after
    return prune


def _tier_phases(tier: str, key_range, wide_pays=None, mat_cap=None):
    """The tier's phases, [(name, fn)]: fn maps the previous phase's output
    tuple to its own; the first takes (rk, rkh, rp, sk, skh, sp) and the
    last returns the tier's outputs, count first."""
    if tier == "key8b":
        if wide_pays is None:
            def probe(a):
                rk, rkh, rp, sk, skh, sp = a
                return xla_join.sort_scan_count_wide(rkh, rk, rp, skh, sk, sp)
        else:
            rph, sph = wide_pays

            def probe(a):
                # 64-bit payloads (reference value_t under KEY_8B,
                # src/types.h:22-28): checksums accumulate mod 2^64
                rk, rkh, rp, sk, skh, sp = a
                c, sr64, ss64 = xla_join.sort_scan_count_wide64(
                    rkh, rk, rph, rp, skh, sk, sph, sp)
                return c, sr64[0], sr64[1], ss64[0], ss64[1]
        return [("probe", probe)]

    if tier == "materialize8b":
        rph, sph = wide_pays

        def probe(a):
            rk, rkh, rp, sk, skh, sp = a
            return xla_join.sort_scan_materialize_wide(
                rkh, rk, rph, rp, skh, sk, sph, sp)
        return [("probe", probe)]

    if tier == "materialize":
        def probe(a):
            rk, _, rp, sk, _, sp = a
            if mat_cap is None:            # unique R (declared stats)
                return xla_join.sort_scan_materialize(rk, rp, sk, sp)
            return xla_join.sort_scan_materialize_multi(       # non-unique
                rk, rp, sk, sp, mat_cap)
        return [("probe", probe)]

    if tier == "sortscan":
        # PRH shape: phase 1 = global radix clustering (the sort — the
        # reference's multi-pass partition taken to its contiguous
        # conclusion); phase 2 = segmented merge scan (build+probe fused).
        def part(a):
            rk, _, rp, sk, _, sp = a
            key = jnp.concatenate([rk, sk])
            tag = jnp.concatenate([jnp.zeros(rk.shape[0], jnp.int32),
                                   jnp.ones(sk.shape[0], jnp.int32)])
            pay = jnp.concatenate([rp, sp])
            return jax.lax.sort((key, tag, pay), num_keys=2)

        def probe(a):
            return xla_join.scan_sorted_count(*a)
        return [("part", part), ("probe", probe)]

    if tier == "ht":
        lo, hi = key_range

        def build(a):
            rk, _, rp, sk, _, sp = a
            cnt_tbl, pay_tbl = ht_join.build_tables(rk, rp, lo, hi)
            return cnt_tbl, pay_tbl, sk, sp

        def probe(a):
            return ht_join.probe_tables(*a, lo, hi)
        return [("build", build), ("probe", probe)]

    raise ValueError(f"unknown tier {tier}")


def _time_phases(phases, args) -> dict[str, float]:
    """Each phase as its own program: warmed once, then timed to
    block_until_ready.  Returns {phase name: usec}."""
    usec: dict[str, float] = {}
    carry = args
    for name, f in phases:
        jf = jax.jit(f)
        jax.block_until_ready(jf(carry))
        t0 = time.perf_counter()
        carry = jax.block_until_ready(jf(carry))
        usec[name] = (time.perf_counter() - t0) * 1e6
    return usec


def run_join(name: str, R: Relation, S: Relation,
             cfg: EngineConfig = EngineConfig(),
             bloom_args: Optional[BloomArgs] = None,
             inner_repeats: int = 1):
    """Execute a named join algorithm; returns (JoinResult, JoinStats, sums).

    sums = (R-payload checksum, S-payload checksum) over the matched pairs,
    mod 2^32 (mod 2^64 under key8b); (0, 0) on the materialize tiers.
    Compile time is reported separately (compile_usec); total_usec is the
    mean over `inner_repeats` back-to-back executions of the compiled join.
    """
    spec = ALGORITHMS[name]
    if spec.family == "npo":
        bloom_args = None  # B_NPO wrappers ignore the filter (main.c:296-312)
    key_range = _key_range(R) if R.key_hi is None else None
    tier = select_tier(spec, R, cfg, key_range)

    wide_pays = None
    if R.payload_hi is not None:
        sph = S.payload_hi if S.payload_hi is not None \
            else jnp.zeros_like(S.payload)
        wide_pays = (R.payload_hi, sph)
    mat_cap = None
    if tier == "materialize" and not (R.stats is not None
                                      and R.stats.is_unique):
        # non-unique (or undeclared) build side: the unique-R compaction
        # would silently drop pairs — pre-count to size the all-pairs
        # expansion (plan-time metadata, like the reference sizing its
        # chained result buffers)
        c0, _, _ = jax.jit(xla_join.sort_scan_count)(
            R.key, R.payload, jnp.where(S.key == PAD, PAD + 1, S.key),
            S.payload)
        mat_cap = max(int(c0), 1)
    phases = _tier_phases(tier, key_range, wide_pays, mat_cap)
    prune = _prune_fn(bloom_args) if bloom_args is not None else None

    def fused(*a):
        s_after = jnp.int32(-1)
        if prune is not None:
            a, s_after = prune(*a)
        for _, f in phases:
            a = f(a)
        return (*a, s_after)

    zeros = jnp.zeros(0, jnp.int32)
    rkh = R.key_hi if R.key_hi is not None else zeros
    skh = S.key_hi if S.key_hi is not None else zeros
    args = (R.key, rkh, R.payload, S.key, skh, S.payload)

    t0 = time.perf_counter()
    compiled = jax.jit(fused).lower(*args).compile()
    jax.block_until_ready(compiled(*args))
    compile_usec = (time.perf_counter() - t0) * 1e6

    timed = phases
    if prune is not None:
        timed = [("prune", lambda a: prune(*a)[0])] + phases
    phase_usec = _time_phases(timed, args) if len(timed) > 1 else {}

    reps = max(1, inner_repeats)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(*args)
    c = int(out[0])  # host readback: waits for every queued execution
    total_usec = (time.perf_counter() - t0) * 1e6 / reps

    s_after_i = int(out[-1])
    s_after = None if s_after_i < 0 else s_after_i
    sums = (0, 0)
    if tier == "materialize":
        _, out_r, out_s, _, _ = out
        result = JoinResult(total_results=c, r_payload=out_r,
                            s_payload=out_s, s_after_filter=s_after)
    elif tier == "materialize8b":
        _, (orh, orl), (osh, osl), _, _ = out

        def i64(hi, lo):
            return ((np.asarray(hi).astype(np.int64) << 32)
                    | (np.asarray(lo).astype(np.uint32).astype(np.int64)))
        result = JoinResult(total_results=c, r_payload=i64(orh, orl),
                            s_payload=i64(osh, osl), s_after_filter=s_after)
    else:
        result = JoinResult(total_results=c, s_after_filter=s_after)
        if len(out) == 6:              # key8b with 64-bit payload sums
            _, srh, srl, ssh, ssl, _ = out
            sums = ((int(srh) & 0xFFFFFFFF) << 32 | (int(srl) & 0xFFFFFFFF),
                    (int(ssh) & 0xFFFFFFFF) << 32 | (int(ssl) & 0xFFFFFFFF))
        else:
            sums = (int(out[1]), int(out[2]))

    stats = JoinStats(
        total_usec=total_usec,
        prune_usec=phase_usec.get("prune", 0.0),
        build_usec=phase_usec.get("build", 0.0),
        part_usec=phase_usec.get("part", 0.0),
        probe_usec=phase_usec.get("probe", total_usec),
        result=c,
        num_s_tuples=S.capacity,
        num_r_tuples=R.capacity,
        s_after_filter=s_after,
        compile_usec=compile_usec,
        tier=tier,
        memory_analysis=compiled.memory_analysis(),
    )
    if cfg.sync_stats:
        from hwbloomradixjoin.utils.timing import print_sync_stats
        print_sync_stats(stats, phase_usec)
    return result, stats, sums
