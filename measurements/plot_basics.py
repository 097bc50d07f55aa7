"""Figure generation — parity with the reference's measurements/plot_basics.py.

The reference regenerates thesis/ICDE figures from committed result files
(plot_basics.py: Balkesen fig 5/9/11/12 + filter validation + theoretical
FPR curve, calc_fpr:19-21).  This module renders the same figure families
from the harness's sweep pickles (measurements/data/*.pkl, written by
measurements/run.py; a missing pickle skips its figure):

    figure11  PRO vs PRH vs PRHO            (sweep_algos / quick data)
    scaling   rows/s + efficiency vs devices (sweep_scaling)
    bloom     basic vs blocked x k           (sweep_bloom)
    fpr       theoretical FPR vs k + golden empirical points

Styling: colorblind-safe fixed-order categorical palette (Okabe-Ito),
single axis per chart, recessive grid, direct labels where few series.

Usage:  python measurements/plot_basics.py [all|figure11|scaling|bloom|fpr]
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "figures")

# fixed-order CVD-safe categorical palette (Okabe-Ito)
C = ["#0072B2", "#E69F00", "#009E73", "#CC79A7", "#56B4E9", "#D55E00"]


def _ax(title, xlabel, ylabel):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 3.6), dpi=130)
    ax.set_title(title, fontsize=11)
    ax.set_xlabel(xlabel, fontsize=9)
    ax.set_ylabel(ylabel, fontsize=9)
    ax.grid(alpha=0.25, linewidth=0.5)
    ax.tick_params(labelsize=8)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    return fig, ax


def _save(fig, name):
    os.makedirs(FIGS, exist_ok=True)
    path = os.path.join(FIGS, f"{name}.png")
    fig.tight_layout()
    fig.savefig(path)
    print(f"wrote {path}")


def _load(name):
    import pandas as pd
    path = os.path.join(DATA, f"{name}.pkl")
    if not os.path.exists(path):
        print(f"skip: measurements/data/{name}.pkl not found "
              f"(run `python measurements/run.py <sweep>` first)")
        return None
    return pd.read_pickle(path)


def plot_scaling():
    """Throughput + efficiency vs mesh devices (new scope vs reference)."""
    df = _load("scaling")
    if df is None:
        return
    d = df.sort_values("devices")
    rows_s = d["s-size"] / (d["time-usecs"] / 1e6)
    fig, ax = _ax("Distributed join scaling (SPMD mesh)",
                  "devices", "S-rows / s")
    ax.plot(d["devices"], rows_s, "-o", color=C[0], linewidth=2,
            markersize=5)
    for x, y, e in zip(d["devices"], rows_s, d["scaling-efficiency"]):
        ax.annotate(f"{e:.0%}", (x, y), textcoords="offset points",
                    xytext=(0, 6), fontsize=8, ha="center")
    ax.set_xscale("log", base=2)
    _save(fig, "scaling")


def plot_bloom():
    """basic vs blocked filter cost across k (ref best_bloom_filter_type)."""
    df = _load("bloom_filter_type")
    if df is None:
        return
    fig, ax = _ax("Bloom filter variant cost", "k (probes per key)",
                  "ns / S-tuple")
    for i, variant in enumerate(("basic", "blocked")):   # fixed order
        d = df[df["bloom_filter"] == variant].sort_values("bloom_hashes")
        ax.plot(d["bloom_hashes"], d["nsec-per-tuple"], "-o", color=C[i],
                linewidth=2, markersize=5, label=variant)
    ax.legend(fontsize=8, frameon=False)
    _save(fig, "bloom_filter_type")


def plot_fpr():
    """Theoretical FPR vs k + the committed golden empirical points.

    calc_fpr parity (reference plot_basics.py:19-21, unit_tests.c:231-232)
    at the golden geometry m=2^30, n=128M (bloom_filter_fpr.txt).
    """
    from hwbloomradixjoin.ops.bloom import theoretical_fpr

    ks = np.arange(1, 13)
    fig, ax = _ax("Bloom FPR vs k  (m=2$^{30}$, n=128M)", "k",
                  "false-positive rate")
    ax.plot(ks, [theoretical_fpr(1 << 30, int(k), 128_000_000) for k in ks],
            "-", color=C[0], linewidth=2, label="theoretical")
    # golden empirical values (measurements/data/bloom_filter_fpr.txt rows)
    golden = {1: 0.11237, 2: 0.04500, 3: 0.02718, 6: 0.01779, 12: 0.03761}
    ax.plot(list(golden), list(golden.values()), "o", color=C[1],
            markersize=6, label="reference empirical (basic)")
    ax.legend(fontsize=8, frameon=False)
    _save(fig, "fpr_curve")


def plot_figure11():
    """PRO / PRH / PRHO / NPO on one workload (ref figure 11 + figure 5).

    Reference (isengard, workload B/A): PRO 9.85, PRH 12.73, PRHO 11.35,
    NPO 8.63 ns/tuple — annotated for scale comparison (different
    hardware; the shape, PRO fastest among radix trio, is the claim).
    """
    df = _load("algos")
    if df is None:
        return
    order = ["PRO", "PRH", "PRHO", "NPO"]
    d = df.set_index("algorithm").reindex(order).dropna(
        subset=["nsec-per-tuple"])
    fig, ax = _ax("Join algorithm comparison (figure-11 analogue)",
                  "", "ns / S-tuple")
    xs = np.arange(len(d))
    ax.bar(xs, d["nsec-per-tuple"], color=[C[i] for i in range(len(d))],
           width=0.62)
    ax.set_xticks(xs)
    ax.set_xticklabels(d.index, fontsize=9)
    for x, v in zip(xs, d["nsec-per-tuple"]):
        ax.annotate(f"{v:.2f}", (x, v), textcoords="offset points",
                    xytext=(0, 3), ha="center", fontsize=8)
    _save(fig, "figure11_algos")


def plot_figure11_b():
    """Figure 11 at the reference's actual workload B (128M x 128M, 8B).

    Reference bars: base_results/figure11/{PRO,PRH,PRHO}_B_14.txt = 9.85 /
    12.73 / 11.35 ns/tuple (isengard, 8 thr, 14 radix bits); the reference
    has no NPO workload-B run, so NPO shows the engine bar only.
    Side-by-side with the engine's measured numbers (algos_B sweep).
    """
    df = _load("algos_B")
    if df is None:
        return
    ref = {"PRO": 9.85, "PRH": 12.73, "PRHO": 11.35}
    order = [a for a in ("PRO", "PRH", "PRHO", "NPO")
             if a in set(df["algorithm"])]
    d = df.set_index("algorithm").reindex(order)
    fig, ax = _ax("Workload B (128M$\\bowtie$128M): engine vs reference",
                  "", "ns / S-tuple")
    xs = np.arange(len(d))
    w = 0.38
    ax.bar(xs - w / 2, [ref.get(a, 0) for a in order], width=w, color=C[3],
           label="reference (isengard, 8 thr)")
    ax.bar(xs + w / 2, d["nsec-per-tuple"], width=w, color=C[0],
           label="this engine (1 device)")
    ax.set_xticks(xs)
    ax.set_xticklabels(order, fontsize=9)
    for x, v in zip(xs + w / 2, d["nsec-per-tuple"]):
        ax.annotate(f"{v:.2f}", (x, v), textcoords="offset points",
                    xytext=(0, 3), ha="center", fontsize=8)
    ax.legend(fontsize=8)
    _save(fig, "figure11_algos_B")


def plot_dist_bloom():
    """Exchange-volume reduction from pre-shuffle bloom pruning."""
    df = _load("dist_bloom")
    if df is None:
        return
    d = df.copy()
    d["label"] = d.apply(
        lambda r: "no filter" if r["bloom_filter"] == "no"
        else f"{r['bloom_filter']} k={r['bloom_hashes']}", axis=1)
    fig, ax = _ax("Distributed: S bytes crossing the interconnect",
                  "", "MiB shuffled")
    xs = np.arange(len(d))
    ax.bar(xs, d["s-exchanged-bytes"] / 2**20,
           color=[C[0] if v == "no" else C[2]
                  for v in d["bloom_filter"]], width=0.62)
    ax.set_xticks(xs)
    ax.set_xticklabels(d["label"], fontsize=8)
    for x, v, red in zip(xs, d["s-exchanged-bytes"] / 2**20,
                         d["exchange-reduction"]):
        ax.annotate(f"{red:.1f}x" if red > 1.01 else "",
                    (x, v), textcoords="offset points",
                    xytext=(0, 3), ha="center", fontsize=8)
    _save(fig, "dist_bloom")


PLOTS = {"scaling": plot_scaling,
         "bloom": plot_bloom, "fpr": plot_fpr,
         "figure11": plot_figure11, "figure11_b": plot_figure11_b,
         "dist_bloom": plot_dist_bloom}


def main(which="all"):
    if which == "all":
        for fn in PLOTS.values():
            fn()
    else:
        PLOTS[which]()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
