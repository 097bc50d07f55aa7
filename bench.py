"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline metric (BASELINE.json): join throughput in S-rows/s on one GPU for
PRO 16M ⋈ 128M at q=1 (BASELINE.json config 2), through `run_join` on
whichever tier the planner picks.  Each timed repeat covers the whole join —
prune, build, partition, probe — as a warmed loop of the compiled program
ending in a host readback, the span of the reference's TOTAL-TIME-USECS
(parallel_radix_join_bloom.c:1509-1547).  The count and both payload
checksums are checked against an exact host reference
(data/reference.lookup_join); a mismatch reports value 0.

Knobs (environment): BENCH_R, BENCH_S, BENCH_Q (selectivity), BENCH_ALGO,
BENCH_REPEATS, BENCH_INNER (warmed executions per repeat).

Needs a GPU: without one it exits non-zero and prints no result.  The
device, its count and the card's name and power limit go to stderr.

Baseline: the reference's best full-scale CPU number — PRO 128M⋈1.024B at
2.98 ns/tuple ≈ 335.6M rows/s (isengard, measurements/data/pkl/isengard.pkl,
BASELINE.md).  vs_baseline = ours / reference.
"""

import json
import os
import sys
import time

BASELINE_ROWS_PER_S = 1e9 / 2.98  # PRO 128M⋈1.024B, 14 thr (BASELINE.md)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from hwbloomradixjoin import runtime

    runtime.setup_compile_cache()
    runtime.select_backend("gpu")

    from hwbloomradixjoin.config import EngineConfig
    from hwbloomradixjoin.data import generator as G, reference
    from hwbloomradixjoin.models import run_join
    from hwbloomradixjoin.types import Relation

    r_size = int(os.environ.get("BENCH_R", 16_000_000))
    s_size = int(os.environ.get("BENCH_S", 128_000_000))
    selectivity = float(os.environ.get("BENCH_Q", 1.0))
    algo = os.environ.get("BENCH_ALGO", "PRO")
    repeats = int(os.environ.get("BENCH_REPEATS", 2))
    inner = int(os.environ.get("BENCH_INNER", 8))

    d = runtime.device_summary()
    log(f"device: platform={d['platform']} device_kind={d['kind']} "
        f"count={d['count']}")
    log(f"nvidia-smi: {runtime.nvidia_smi_line()}")
    log(f"bench: {algo} {r_size}⋈{s_size} q={selectivity}")

    t0 = time.perf_counter()
    params = G.WorkloadParams(r_size=r_size, s_size=s_size, nthreads=8,
                              selectivity=selectivity)
    rk, rp, sk, sp = G.build_workload(params)
    want = reference.lookup_join(rk, rp, sk, sp)
    log(f"datagen + reference: {time.perf_counter() - t0:.1f}s")
    R = Relation.from_numpy(rk, rp, stats=G.r_key_stats(params))
    S = Relation.from_numpy(sk, sp)
    del rk, rp, sk, sp

    best = None
    for i in range(repeats):
        result, stats, sums = run_join(algo, R, S, EngineConfig(), None,
                                       inner_repeats=inner)
        log(f"run {i}: tier={stats.tier} {stats.total_usec / 1e6:.6f}s "
            f"({stats.nsec_per_tuple:.4f} ns/tuple) "
            f"build={stats.build_usec / 1e3:.3f}ms "
            f"part={stats.part_usec / 1e3:.3f}ms "
            f"probe={stats.probe_usec / 1e3:.3f}ms "
            f"results={result.count()} sums={sums}")
        if best is None or stats.total_usec < best.total_usec:
            best = stats
    got = (result.count(), sums[0], sums[1])
    expect = (want[0], want[1] % 2**32, want[2] % 2**32)
    if got != expect:
        log(f"VALIDATION FAILED: (count, R sum, S sum) {got} != {expect}")
        value = 0.0
    else:
        log(f"validated: count and both checksums equal the reference "
            f"{expect}")
        value = s_size / (best.total_usec / 1e6)

    print(json.dumps({
        "metric": f"{algo} join throughput ({r_size // 10**6}M⋈"
                  f"{s_size // 10**6}M, 1 GPU, tier={best.tier}, build incl)",
        "value": round(value, 0),
        "unit": "rows/s",
        "vs_baseline": round(value / BASELINE_ROWS_PER_S, 4),
    }))


if __name__ == "__main__":
    main()
