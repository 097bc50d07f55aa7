"""Experiment sweep driver — parity with the reference measurements/run.py.

Runs the engine CLI as a subprocess per configuration, regex-parses the
stdout timing block (the SAME parse as the reference's parse_result,
run.py:100-156 — both binaries emit identical line formats), and collects
pandas dataframes saved as pkl + markdown.

Sweeps mirrored from the reference:
  best_bloom_filter_type  (basic vs blocked x k x scales; run.py:272)
  test_parameters         (|R| x S:R ratio x q x k; run.py:326)
plus `algos` (figure 11), `scaling` and `dist_bloom` (device-count scaling
and pre-shuffle pruning, new scope).  Nothing here is committed data: the
sweeps write measurements/data/ when run.

Usage:
  python measurements/run.py quick          # small smoke sweep
  python measurements/run.py bloom          # filter-type sweep
  python measurements/run.py params         # parameter sweep
"""

from __future__ import annotations

import itertools
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from config import JoinConfig  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def parse_result(res: str) -> dict:
    """Parse engine/reference stdout (identical to reference parse_result)."""
    s_size = int(re.search(
        r"relation S with size = [\d.]+ MiB, #tuples = (\d+) : OK", res).group(1))
    filtered = re.search(r"S-tuples after filter: (\d+)\n", res)
    filtered = int(filtered.group(1)) if filtered else None
    runtime, build, part = re.search(
        r"RUNTIME TOTAL, BUILD, PART \(cycles\):\s+(\d+)\s+(\d+)\s+(\d+)",
        res).groups()
    usecs, out_tuples, nsec = re.search(
        r"TOTAL-TIME-USECS, TOTAL-TUPLES, NSEC-PER-TUPLE:\s+([\d.]+)\s+(\d+)\s+([\d.]+)",
        res).groups()
    part_us, probe_us, join_us = re.search(
        r"PARTITION-TIME-USECS, PROBE-TIME-USECS, JOIN-TIME-USECS:\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)",
        res).groups()
    results = re.search(r"Results = (\d+)\. DONE", res)
    return {
        "s-size": s_size,
        "filtered": filtered,
        "filtered-pct": filtered / s_size * 100 if filtered else None,
        "runtime-cycles": int(runtime),
        "build-cycles": int(build),
        "part-cycles": int(part),
        "time-usecs": float(usecs),
        "out-tuples": int(out_tuples),
        "nsec-per-tuple": float(nsec),
        "partition-usecs": float(part_us),
        "probe-usecs": float(probe_us),
        "join-usecs": float(join_us),
        "results": int(results.group(1)) if results else None,
    }


def run_one(cfg: JoinConfig, timeout: int = 1200, env: dict | None = None) -> dict:
    cmd = [sys.executable, "-m", "hwbloomradixjoin.cli"] + cfg.to_args()
    t0 = time.time()
    run_env = dict(os.environ)
    if env:
        run_env.update(env)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                          env=run_env,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-2000:]}")
    row = {**dataclass_dict(cfg), **parse_result(proc.stdout),
           "wall-secs": time.time() - t0}
    return row


def dataclass_dict(cfg) -> dict:
    import dataclasses
    return dataclasses.asdict(cfg)


def save_data(rows: list[dict], name: str):
    import pandas as pd

    os.makedirs(DATA_DIR, exist_ok=True)
    df = pd.DataFrame(rows)
    df.to_pickle(os.path.join(DATA_DIR, f"{name}.pkl"))
    with open(os.path.join(DATA_DIR, f"{name}.md"), "w") as f:
        f.write(df.to_markdown(index=False))
    print(f"saved {len(df)} rows -> measurements/data/{name}.pkl/.md")
    return df


def sweep_quick(backend="cpu"):
    rows = []
    for algo in ("NPO_st", "PRO"):
        for bloom in ("no", "blocked"):
            if algo.startswith("NPO") and bloom != "no":
                continue
            cfg = JoinConfig(algorithm=algo, r_size=100_000, s_size=400_000,
                             selectivity=0.25, threads=4, bloom_filter=bloom,
                             bloom_size=1 << 20, bloom_hashes=2,
                             backend=backend)
            rows.append(run_one(cfg))
    return save_data(rows, "quick")


def sweep_bloom(backend="gpu", r_size=1_000_000, s_size=8_000_000,
                m=None, inner=4, ks=(1, 2, 4, 8)):
    """best_bloom_filter_type parity: basic vs blocked x k (run.py:272).

    Includes a no-bloom PRO row as the comparison base (the thesis
    question is bloom's *speedup over the plain join*).  Default m
    scales with |R| (reference uses m=2^30 at the 128M flagship).
    """
    if m is None:
        m = 1 << min(max((r_size * 8 - 1).bit_length(), 20), 30)
    rows = []
    base = JoinConfig(algorithm="PRO", r_size=r_size, s_size=s_size,
                      selectivity=0.01, inner=inner,
                      backend=backend)
    row = run_one(base, timeout=7200)
    row["bloom"], row["k"] = "no", 0
    rows.append(row)
    save_data(rows, "bloom_filter_type")
    for variant, k in itertools.product(("blocked", "basic"), tuple(ks)):
        cfg = JoinConfig(algorithm="PRO", r_size=r_size, s_size=s_size,
                         selectivity=0.01, bloom_filter=variant,
                         bloom_size=m, bloom_hashes=k,
                         inner=inner, backend=backend)
        row = run_one(cfg, timeout=7200)
        row["bloom"], row["k"] = variant, k
        rows.append(row)
        save_data(rows, "bloom_filter_type")
    return save_data(rows, "bloom_filter_type")


def sweep_params(backend="gpu", inner=4, r_sizes=(250_000, 1_000_000)):
    """test_parameters parity: |R| x ratio x q (run.py:326).

    The reference's full grid also sweeps threads and bits/key; the
    engine's thread axis is the device mesh (scaling sweep) and it has no
    radix-bits knob, so the grid here is |R| x S:R x q.
    """
    rows = []
    for r_size, ratio, q in itertools.product(
            r_sizes, (1, 4, 8), (0.001, 0.01, 0.1)):
        cfg = JoinConfig(algorithm="PRO", r_size=r_size,
                         s_size=r_size * ratio, selectivity=q,
                         inner=inner, backend=backend)
        row = run_one(cfg, timeout=7200)
        row["ratio"], row["q"] = ratio, q
        rows.append(row)
        save_data(rows, "test_parameters")
    return save_data(rows, "test_parameters")


def sweep_scaling(r_size=500_000, s_size=4_000_000, max_devices=8):
    """Device-count scaling: 1 -> N mesh devices, efficiency column.

    Runs the distributed SPMD join (psum histograms + all_to_all shuffle)
    on a virtual CPU mesh (xla_force_host_platform_device_count) so the
    sweep works without several cards; on real cards the same flags run
    over their interconnect.  Efficiency = T(1) / (N * T(N)) on rows/s.

    READ THE NUMBER CAREFULLY: on a virtual mesh all N "devices" share
    one host's cores, and the 1-device XLA program already uses them all
    (intra-op threading), so per-device efficiency CANNOT approach 1.0
    here by construction — it measures SPMD overhead (shuffle, capacity
    padding, replicated work), not hardware scaling.  The wall-clock
    SPEEDUP column is the honest virtual-mesh signal; the >=80%
    efficiency target (BASELINE) is a criterion for real cards, which
    this CPU sweep cannot measure.
    """
    rows = []
    env = {"JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={max_devices}"}
    base = None
    n = 1
    while n <= max_devices:
        cfg = JoinConfig(algorithm="PRO", r_size=r_size, s_size=s_size,
                         selectivity=0.25, backend="cpu", devices=n,
                         repeats=3)
        row = run_one(cfg, env=env, timeout=7200)
        row["devices"] = n
        if base is None:
            base = row["time-usecs"]
        row["scaling-efficiency"] = base / (n * row["time-usecs"])
        row["speedup-vs-1dev"] = base / row["time-usecs"]
        rows.append(row)
        save_data(rows, "scaling")
        n *= 2
    return save_data(rows, "scaling")


def sweep_algos(backend="gpu", r_size=1_000_000, s_size=8_000_000,
                inner=4, name="algos"):
    """Figure-11 analogue: PRO vs PRH vs PRHO (vs NPO), one workload.

    The reference's three-way build/probe-kernel comparison
    (base_results/figure11: 9.85 / 12.73 / 11.35 ns/tuple); each name runs
    on the tier the planner picks for it (models/registry.py), timed as
    `inner` warmed executions.  Rows append incrementally so long sweeps
    survive interruption.
    """
    import pandas as pd

    rows = []
    pkl = os.path.join(DATA_DIR, f"{name}.pkl")
    if os.path.exists(pkl):
        prev = pd.read_pickle(pkl)
        if len(prev) and (prev["r_size"] == r_size).all():
            rows = prev.to_dict("records")
    done = {r.get("algo") for r in rows}
    for algo in ("PRO", "PRH", "PRHO", "NPO"):
        if algo in done:
            continue
        cfg = JoinConfig(algorithm=algo, r_size=r_size, s_size=s_size,
                         backend=backend, inner=inner)
        row = run_one(cfg, timeout=7200)
        row["algo"] = algo
        rows.append(row)
        save_data(rows, name)
    return save_data(rows, name)


def sweep_algos_b(backend="gpu", inner=2):
    """sweep_algos at the reference's workload B (128M x 128M, 8B tuples):
    base_results/figure11/{PRO,PRH,PRHO}_B_14.txt = 9.85 / 12.73 / 11.35
    ns/tuple on isengard."""
    return sweep_algos(backend=backend, r_size=128_000_000,
                       s_size=128_000_000, inner=inner, name="algos_B")


def sweep_dist_bloom(r_size=1_000_000, s_size=8_000_000, devices=8):
    """Distributed bloom: exchange-volume reduction from pre-shuffle prune.

    S tuples failing the filter never cross the interconnect.  Rows record the
    survivor count and the implied shuffled-S bytes with/without filter.
    """
    rows = []
    env = {"JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    for variant, k in (("no", 0), ("blocked", 1), ("blocked", 4),
                       ("basic", 1)):
        cfg = JoinConfig(algorithm="PRO", r_size=r_size, s_size=s_size,
                         selectivity=0.01, backend="cpu", devices=devices,
                         bloom_filter=variant, bloom_hashes=max(k, 1),
                         bloom_size=1 << 26, repeats=3)
        row = run_one(cfg, env=env)
        row["devices"] = devices
        surv = row["filtered"] if row["filtered"] is not None else s_size
        row["s-exchanged-bytes"] = surv * 8
        row["exchange-reduction"] = s_size / max(surv, 1)
        rows.append(row)
        save_data(rows, "dist_bloom")
    return save_data(rows, "dist_bloom")


SWEEPS = {"quick": sweep_quick, "bloom": sweep_bloom, "params": sweep_params,
          "dist_bloom": sweep_dist_bloom,
          "scaling": sweep_scaling,
          "algos": sweep_algos, "algos_b": sweep_algos_b}


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "quick"
    kwargs = {}
    for k, env in (("r_size", "HBRJ_SWEEP_R"), ("s_size", "HBRJ_SWEEP_S"),
                   ("inner", "HBRJ_SWEEP_INNER"), ("m", "HBRJ_SWEEP_M")):
        v = os.environ.get(env)
        if v is not None:
            kwargs[k] = int(v)
    if os.environ.get("HBRJ_SWEEP_KS"):
        kwargs["ks"] = tuple(
            int(x) for x in os.environ["HBRJ_SWEEP_KS"].split(","))
    if os.environ.get("HBRJ_SWEEP_RSIZES"):
        kwargs["r_sizes"] = tuple(
            int(x) for x in os.environ["HBRJ_SWEEP_RSIZES"].split(","))
    import inspect
    sig = inspect.signature(SWEEPS[which])
    kwargs = {k: v for k, v in kwargs.items() if k in sig.parameters}
    SWEEPS[which](**kwargs)
