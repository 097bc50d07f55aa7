#!/usr/bin/env python3
"""Smoke test of the join engine on one NVIDIA GPU (four with --four-cards).

Drives the engine through the entry points a user calls (`run_join`, the
CLI's `main`) at the reference's own sizes, and checks every result exactly
against a host reference that shares no code with the engine:
`data.reference.lookup_join` (numpy direct-address lookup, for unique build
keys), `native.ref_join` (scalar hash table) and `native.ref_bloom` (scalar
filter).  Counts and checksums are integers, so every comparison is exact.

One process holds the card for the whole run; the CLI runs in-process.

Phases, one line each (result, verdict, warmed wall time, peak device
memory, the card's name and power limit):

  1. device      refuse to run unless JAX's first device is a GPU
  2. main path   PRO 16M ⋈ 128M, q=1 (BASELINE.json config 2)
  3. flagship    BPRO 128M ⋈ 1.024B, q=0.01, blocked m=2^30 B=512 k=1
  4. tiers       sortscan (PRH, workload B 128M ⋈ 128M), ht with a
                 non-unique build (NPO 1M ⋈ 8M), key8b (workload A
                 2^24 ⋈ 2^28, 16-byte tuples), materialize (unique R,
                 pairs checked), the full-int32-span workload on sortscan
                 with and without the blocked filter, and one CLI run
  5. --four-cards  only the distributed flagship over a 4-device mesh,
                 inputs placed beforehand, the step alone timed

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any mismatch or error ends the run with a non-zero exit and no such line.

Usage:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time

import numpy as np

from hwbloomradixjoin import runtime

# filter geometry of the thesis flagship (BASELINE.json config 3)
FLAGSHIP_BLOOM = dict(m=1 << 30, k=1, B=512)
INNER = 3          # warmed executions per timed loop

CARD = "not read"  # nvidia-smi name and power limit, set by phase_device


class Mismatch(AssertionError):
    pass


def check(what: str, got, want) -> None:
    if got != want:
        raise Mismatch(f"{what}: got {got}, want {want}")


def _peak_bytes() -> str:
    import jax

    peaks = []
    for d in jax.local_devices():
        st = d.memory_stats()
        peaks.append(str(st["peak_bytes_in_use"]) if st else "n/a")
    return ",".join(peaks)


def report(phase: str, result: str, ref: str, wall_s: float,
           extra: str = "") -> None:
    print(f"[{phase}] {result} | exact match vs {ref} | wall "
          f"{wall_s:.6f} s (warmed, to readback) | peak_bytes_in_use "
          f"{_peak_bytes()} | card {CARD}{extra}", flush=True)


def _relations(rk, rp, sk, sp, stats=None, key8b=False):
    from hwbloomradixjoin.types import Relation

    return (Relation.from_numpy(rk, rp, stats=stats, key8b=key8b),
            Relation.from_numpy(sk, sp, key8b=key8b))


def _gbps(st, tuple_bytes: int = 8) -> str:
    """Input GB/s: the bytes of R's and S's tuples over the join's time."""
    nbytes = tuple_bytes * (st.num_r_tuples + st.num_s_tuples)
    return f"{nbytes / (st.total_usec * 1e-6) / 1e9:.3f}"


def _uniform(r: int, s: int, q: float, key8b: bool = False):
    from hwbloomradixjoin.data import generator as G

    params = G.WorkloadParams(r_size=r, s_size=s, nthreads=8,
                              selectivity=q, key8b=key8b)
    return params, G.build_workload(params)


def _join_line(st, res, sums, tuple_bytes: int = 8) -> str:
    return (f"tier={st.tier} count={res.count()} sums={sums} "
            f"total={st.total_usec / 1e6:.6f}s "
            f"({st.nsec_per_tuple:.4f} ns/S-tuple, input "
            f"{_gbps(st, tuple_bytes)} GB/s) "
            f"compile={st.compile_usec / 1e6:.3f}s "
            f"phases: prune={st.prune_usec / 1e3:.3f}ms "
            f"build={st.build_usec / 1e3:.3f}ms "
            f"part={st.part_usec / 1e3:.3f}ms "
            f"probe={st.probe_usec / 1e3:.3f}ms")


def _check_join(tag, res, sums, want, mod=2**32) -> None:
    check(f"{tag} count", res.count(), want[0])
    check(f"{tag} R checksum", sums[0], want[1] % mod)
    check(f"{tag} S checksum", sums[1], want[2] % mod)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(min_count: int = 1, backend: str = "gpu") -> dict:
    """Phase 1: refuse to run unless JAX's first device is a GPU."""
    global CARD
    from hwbloomradixjoin.utils import roofline

    runtime.select_backend(backend)
    d = runtime.device_summary()
    CARD = runtime.nvidia_smi_line()
    print(f"[device] platform={d['platform']} device_kind={d['kind']} "
          f"count={d['count']} | nvidia-smi: {CARD}", flush=True)
    if d["count"] < min_count:
        raise RuntimeError(f"need {min_count} devices, found {d['count']}")
    if backend == "gpu":
        chip = roofline.chip_model()
        print(f"[device] published peak: {chip.hbm_gbps:.0f} GB/s device "
              f"memory, {chip.hbm_gb} GB ({chip.source})", flush=True)
    return d


def phase_main_path(r: int = 16_000_000, s: int = 128_000_000):
    """Phase 2: PRO r ⋈ s at q=1 through run_join; returns the data."""
    from hwbloomradixjoin.config import EngineConfig
    from hwbloomradixjoin.data import generator as G, reference
    from hwbloomradixjoin.models import run_join

    params, (rk, rp, sk, sp) = _uniform(r, s, 1.0)
    want = reference.lookup_join(rk, rp, sk, sp)
    R, S = _relations(rk, rp, sk, sp, G.r_key_stats(params))
    res, st, sums = run_join("PRO", R, S, EngineConfig(), None, INNER)
    _check_join("PRO", res, sums, want)
    report(f"main PRO {r}x{s} q=1", _join_line(st, res, sums),
           "numpy direct-address lookup (data/reference.lookup_join)",
           st.total_usec / 1e6)
    return rk, rp, sk, sp


def phase_materialize(rk, rp, sk, sp):
    """Phase 4: --materialize with a unique R; every pair is checked.

    Payloads are row ids, so a pair is right iff R row out_r holds the key
    of S row out_s; the S rows paired must be exactly the matching ones.
    """
    from hwbloomradixjoin.config import EngineConfig
    from hwbloomradixjoin.data import reference
    from hwbloomradixjoin.models import run_join
    from hwbloomradixjoin.types import KeyStats

    check("R payloads are row ids", bool((rp == np.arange(len(rp))).all()),
          True)
    check("S payloads are row ids", bool((sp == np.arange(len(sp))).all()),
          True)
    stats = KeyStats(int(rk.min()), int(rk.max()), is_unique=True)
    R, S = _relations(rk, rp, sk, sp, stats)
    res, st, _ = run_join("PRO", R, S, EngineConfig(materialize=True), None,
                          INNER)
    rows = reference.matched_rows(rk, sk)
    n = res.count()
    check("materialize count", n, int(np.count_nonzero(rows >= 0)))
    out_r = np.asarray(res.r_payload)[:n]
    out_s = np.asarray(res.s_payload)[:n]
    seen = np.bincount(out_s, minlength=len(sk))
    check("each matching S row emitted once",
          bool(np.array_equal(seen, (rows >= 0).astype(seen.dtype))), True)
    check("each pair joins equal keys",
          bool(np.array_equal(rows[out_s], out_r)), True)
    check("tier", st.tier, "materialize")
    report(f"materialize PRO {len(rk)}x{len(sk)}",
           f"tier={st.tier} pairs={n} total={st.total_usec / 1e6:.6f}s "
           f"({st.nsec_per_tuple:.4f} ns/S-tuple, input "
           f"{_gbps(st)} GB/s)",
           "numpy direct-address lookup, pair by pair", st.total_usec / 1e6)


def phase_flagship(r: int = 128_000_000, s: int = 1_024_000_000,
                   q: float = 0.01, bloom=FLAGSHIP_BLOOM):
    """Phase 3: BPRO r ⋈ s, blocked filter, through run_join."""
    from hwbloomradixjoin.config import BloomArgs, BloomVariant, EngineConfig
    from hwbloomradixjoin.data import generator as G, native, reference
    from hwbloomradixjoin.models import run_join

    params, (rk, rp, sk, sp) = _uniform(r, s, q)
    args = BloomArgs(variant=BloomVariant.BLOCKED, **bloom)
    want = reference.lookup_join(rk, rp, sk, sp)
    check("reference count vs expected_uniform_match_count", want[0],
          G.expected_uniform_match_count(s, q))
    want_after = int(native.ref_bloom("blocked", args.m, args.k, args.B,
                                      args.seed, rk, sk).sum())
    R, S = _relations(rk, rp, sk, sp, G.r_key_stats(params))
    res, st, sums = run_join("PRO", R, S, EngineConfig(), args, INNER)
    _check_join("BPRO", res, sums, want)
    check("s_after_filter", res.s_after_filter, want_after)
    share = st.prune_usec / st.total_usec
    report(f"flagship BPRO {r}x{s} q={q} blocked m={args.m} B={args.B} "
           f"k={args.k}",
           _join_line(st, res, sums)
           + f" s_after_filter={res.s_after_filter} prune_share={share:.4f}",
           "numpy direct-address lookup + native.ref_bloom",
           st.total_usec / 1e6,
           extra=f" | memory_analysis {_memory(st)}")


def _memory(st) -> str:
    ma = st.memory_analysis
    if ma is None:
        return "n/a"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{f}={getattr(ma, f, 'n/a')}" for f in fields)


def phase_sortscan(r: int = 128_000_000, s: int = 128_000_000):
    """Phase 4: PRH on workload B — the sort tier."""
    from hwbloomradixjoin.config import EngineConfig
    from hwbloomradixjoin.data import generator as G, reference
    from hwbloomradixjoin.models import run_join

    params, (rk, rp, sk, sp) = _uniform(r, s, 1.0)
    want = reference.lookup_join(rk, rp, sk, sp)
    R, S = _relations(rk, rp, sk, sp, G.r_key_stats(params))
    res, st, sums = run_join("PRH", R, S, EngineConfig(), None, INNER)
    check("tier", st.tier, "sortscan")
    _check_join("PRH", res, sums, want)
    report(f"sortscan PRH {r}x{s} q=1",
           _join_line(st, res, sums),
           "numpy direct-address lookup", st.total_usec / 1e6)


def phase_ht_nonunique(r: int = 1_000_000, s: int = 8_000_000):
    """Phase 4: NPO with a non-unique build side on the count table."""
    from hwbloomradixjoin.config import EngineConfig
    from hwbloomradixjoin.data import generator as G, native
    from hwbloomradixjoin.models import run_join

    params = G.WorkloadParams(r_size=r, s_size=s, nthreads=8,
                              nonunique_keys=True)
    rk, rp, sk, sp = G.build_workload(params)
    want = native.ref_join(rk, rp, sk, sp)
    R, S = _relations(rk, rp, sk, sp)
    res, st, sums = run_join("NPO", R, S, EngineConfig(), None, INNER)
    check("tier", st.tier, "ht")
    _check_join("NPO non-unique", res, sums, want)
    report(f"ht NPO {r}x{s} --non-unique",
           _join_line(st, res, sums), "native.ref_join",
           st.total_usec / 1e6)


def phase_key8b(r: int = 1 << 24, s: int = 1 << 28):
    """Phase 4: workload A, 16-byte tuples; checksums mod 2^64."""
    from hwbloomradixjoin.config import EngineConfig
    from hwbloomradixjoin.data import generator as G, reference
    from hwbloomradixjoin.models import run_join

    params, (rk, rp, sk, sp) = _uniform(r, s, 1.0, key8b=True)
    want = reference.lookup_join(rk, rp, sk, sp)
    R, S = _relations(rk, rp, sk, sp, G.r_key_stats(params), key8b=True)
    res, st, sums = run_join("PRO", R, S, EngineConfig(), None, INNER)
    check("tier", st.tier, "key8b")
    _check_join("key8b", res, sums, want, mod=2**64)
    report(f"key8b PRO {r}x{s} 16B tuples",
           _join_line(st, res, sums, 16),
           "numpy direct-address lookup (mod 2^64)", st.total_usec / 1e6)


def inrange_workload(n_r: int, n_s: int, q: float, seed: int = 9):
    """Sparse unique R over [1, 2^31) and S whose non-matching keys lie
    inside R's span, so the key range prunes nothing."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(1, (1 << 31) - 1, int(n_r * 1.05) + 64,
                        dtype=np.int64)
    rk = np.unique(cand)[:n_r]
    check("distinct R keys drawn", rk.shape[0], n_r)
    rng.shuffle(rk)
    rk = rk.astype(np.int32)
    n_match = int(n_s * q)
    sk = np.concatenate([
        rng.choice(rk, n_match),
        rng.integers(1, (1 << 31) - 1, n_s - n_match).astype(np.int32),
    ]).astype(np.int32)
    rng.shuffle(sk)
    return (rk, np.arange(n_r, dtype=np.int32), sk,
            np.arange(n_s, dtype=np.int32))


def phase_fullspan(r: int = 16_000_000, s: int = 128_000_000,
                   q: float = 0.01, bloom=FLAGSHIP_BLOOM):
    """Phase 4: the full-int32-span workload on sortscan, PRO and BPRO."""
    from hwbloomradixjoin.config import BloomArgs, BloomVariant, EngineConfig
    from hwbloomradixjoin.data import native
    from hwbloomradixjoin.models import run_join
    from hwbloomradixjoin.types import KeyStats

    rk, rp, sk, sp = inrange_workload(r, s, q)
    want = native.ref_join(rk, rp, sk, sp)
    stats = KeyStats(int(rk.min()), int(rk.max()), is_unique=True)
    R, S = _relations(rk, rp, sk, sp, stats)
    args = BloomArgs(variant=BloomVariant.BLOCKED, **bloom)
    want_after = int(native.ref_bloom("blocked", args.m, args.k, args.B,
                                      args.seed, rk, sk).sum())
    for name, b in (("PRO", None), ("BPRO", args)):
        res, st, sums = run_join("PRO", R, S, EngineConfig(), b, INNER)
        check("tier", st.tier, "sortscan")
        _check_join(f"full-span {name}", res, sums, want)
        line = _join_line(st, res, sums)
        ref = "native.ref_join"
        if b is not None:
            check("s_after_filter", res.s_after_filter, want_after)
            line += f" s_after_filter={res.s_after_filter}"
            ref += " + native.ref_bloom"
        report(f"full-span {name} {r}x{s} q={q}", line, ref,
               st.total_usec / 1e6)


def phase_cli(backend: str = "gpu", r: int = 1_000_000, s: int = 8_000_000):
    """Phase 4: one in-process CLI run; its Results line is checked."""
    from hwbloomradixjoin import cli
    from hwbloomradixjoin.data import generator as G

    argv = ["-a", "PRO", "-r", str(r), "-s", str(s), "-q", "0.5",
            "-b", "blocked", "-m", str(1 << 24), "-k", "1", "-B", "512",
            "--engine-repeats", "2", "--engine-backend", backend]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    text = out.getvalue()
    check("cli exit code", rc, 0)
    m = re.search(r"Results = (\d+)\. DONE\.", text)
    check("cli Results line", int(m.group(1)) if m else None,
          G.expected_uniform_match_count(s, 0.5))
    usec = float(re.search(r"TOTAL-TIME-USECS, TOTAL-TUPLES, "
                           r"NSEC-PER-TUPLE: \n([\d.]+)", text).group(1))
    report(f"cli {' '.join(argv)}", m.group(0),
           "expected_uniform_match_count", usec / 1e6)


def phase_four_cards(r: int = 128_000_000, s: int = 1_024_000_000,
                     q: float = 0.01, n_dev: int = 4, bloom=FLAGSHIP_BLOOM):
    """Phase 5: the flagship over an n_dev mesh, blocked filter before the
    shuffle; inputs placed beforehand, the step alone timed."""
    import jax

    from hwbloomradixjoin.config import BloomArgs, BloomVariant
    from hwbloomradixjoin.data import generator as G, native, reference
    from hwbloomradixjoin.parallel import dist_join, mesh as mesh_lib

    _, (rk, rp, sk, sp) = _uniform(r, s, q)
    args = BloomArgs(variant=BloomVariant.BLOCKED, **bloom)
    want = reference.lookup_join(rk, rp, sk, sp)
    check("reference count vs expected_uniform_match_count", want[0],
          G.expected_uniform_match_count(s, q))
    want_after = int(native.ref_bloom("blocked", args.m, args.k, args.B,
                                      args.seed, rk, sk).sum())
    mesh = mesh_lib.make_mesh(n_dev)
    cols = jax.block_until_ready(dist_join.place(mesh, rk, rp, sk, sp))
    kw = dict(bloom_args=args, key_range=(1, r))
    t0 = time.perf_counter()
    out = jax.block_until_ready(dist_join.dist_join_count(mesh, *cols, **kw))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(INNER):
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            dist_join.dist_join_count(mesh, *cols, **kw))
        times.append(time.perf_counter() - t0)
    cnt, sr, ss, s_after, ovf = (int(x) for x in out)
    check("shuffle overflow", ovf, 0)
    check("dist count", cnt, want[0])
    check("dist R checksum", sr, want[1] % 2**32)
    check("dist S checksum", ss, want[2] % 2**32)
    check("dist s_after_filter", s_after, want_after)
    step = min(times)
    report(f"four-cards BPRO {r}x{s} q={q} over {n_dev} devices",
           f"count={cnt} sums=({sr}, {ss}) s_after_filter={s_after} "
           f"step={step:.6f}s (min of {INNER}; all {times}) "
           f"({step * 1e9 / s:.4f} ns/S-tuple) first call incl. compile="
           f"{compile_s:.3f}s",
           "numpy direct-address lookup + native.ref_bloom", step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed flagship on 4 devices")
    args = ap.parse_args(argv)
    runtime.setup_compile_cache()
    d = phase_device(min_count=4 if args.four_cards else 1)
    if args.four_cards:
        phase_four_cards()
    else:
        data = phase_main_path()
        phase_materialize(*data)
        del data
        phase_flagship()
        phase_sortscan()
        phase_ht_nonunique()
        phase_key8b()
        phase_fullspan()
        phase_cli()
    print(json.dumps({"ok": True, "device": {
        "platform": d["platform"], "kind": d["kind"], "count": d["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
