"""Analysis of sweep results — parity with the reference measurements/analysis.py.

Implements the reference's core derived metrics over the pkl dataframes
(analysis.py:57-123, 922-941): empirical-vs-theoretical FPR, bloom speedup
vs no-bloom baseline, cache/VMEM footprint classes, and the BRJ-superiority
fraction.  Table output as markdown; plots optional (matplotlib if present).

Usage: python measurements/analysis.py [pkl ...]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def add_fpr(df):
    """Empirical + theoretical FPR columns (reference add_fpr, analysis.py:57-67).

    fpr_theo = (1 - (1 - 1/m)^(k n))^k; empirical from the filtered count:
    survivors = true matches + FP * negatives.
    """
    import numpy as np

    sel = df["selectivity"].astype(float)
    true_matches = (df["s-size"] * sel).round()
    negatives = df["s-size"] - true_matches
    df["fpr_emp"] = (df["filtered"] - true_matches) / negatives
    df["fpr_theo"] = (1 - (1 - 1 / df["bloom_size"].astype(float))
                      ** (df["bloom_hashes"] * df["r_size"])) ** df["bloom_hashes"]
    df.loc[df["filtered"].isna(), ["fpr_emp", "fpr_theo"]] = np.nan
    return df


def add_speedup(df, baseline_col="nsec-per-tuple"):
    """Speedup vs the matching no-bloom row (reference add_speedup :74-91)."""
    base = df[df["bloom_filter"] == "no"].set_index(
        ["algorithm", "r_size", "s_size", "selectivity"])[baseline_col]

    def speed(row):
        key = (row["algorithm"], row["r_size"], row["s_size"],
               row["selectivity"])
        if key in base.index:
            return float(base.loc[key]) / row[baseline_col]
        return None

    df["speedup"] = df.apply(speed, axis=1)
    return df


def footprint_class(r_size: int, tuple_bytes: int = 8,
                    vmem_bytes: int = 128 << 20) -> str:
    """S/M/L working-set class vs VMEM (reference get_required_space:107-123
    classifies vs cache levels; VMEM plays that role here)."""
    ws = r_size * tuple_bytes
    if ws <= vmem_bytes // 8:
        return "S"
    if ws <= vmem_bytes:
        return "M"
    return "L"


def brj_superiority(df):
    """Fraction of configs where a bloom variant beats its no-bloom twin
    (reference brj_superiority, analysis.py:922-941)."""
    d = df.dropna(subset=["speedup"])
    if len(d) == 0:
        return float("nan")
    return float((d["speedup"] > 1.0).mean())


def best_config_table(df, group_cols=("selectivity",), 
                      metric="nsec-per-tuple"):
    """Best configuration per workload group (the reference analysis.py's
    best-config tables by (q, ratio, k) — the thesis's 'which filter
    settings win where' question)."""
    import pandas as pd

    d = df.dropna(subset=[metric])
    cols = [c for c in group_cols if c in d.columns]
    if not cols or len(d) == 0:
        return None
    idx = d.groupby(cols)[metric].idxmin()
    keep = [c for c in (*cols, "algorithm", "bloom_filter", "bloom_hashes",
                        "radix_bits", "passes", metric, "filtered-pct",
                        "speedup") if c in d.columns]
    return d.loc[idx, keep].reset_index(drop=True)


def footprint_breakdown(df, metric="nsec-per-tuple"):
    """Per-footprint-class aggregation (reference classifies workloads by
    cache footprint S/M/L, analysis.py:107-123; VMEM plays that role)."""
    if "footprint" not in df or metric not in df:
        return None
    g = df.dropna(subset=[metric]).groupby("footprint")[metric]
    out = g.agg(["count", "min", "mean", "max"]).reset_index()
    out.columns = ["footprint", "configs", f"best {metric}",
                   f"mean {metric}", f"worst {metric}"]
    return out


def fpr_plot(df, out_png: str):
    """Empirical vs theoretical FPR by k FROM SWEEP ROWS (the reference's
    bloom_filter_fpr plot family, analysis.py:126-180) — complements the
    standalone golden-table curve with measured engine rows."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    d = df.dropna(subset=["fpr_emp", "fpr_theo"])
    if len(d) == 0:
        return None
    fig, ax = plt.subplots(figsize=(5, 3.4))
    for variant, dd in d.groupby("bloom_filter"):
        dd = dd.sort_values("bloom_hashes")
        ax.plot(dd["bloom_hashes"], dd["fpr_emp"] * 100, "o-",
                label=f"{variant} (empirical)")
    dd = d.sort_values("bloom_hashes").drop_duplicates("bloom_hashes")
    ax.plot(dd["bloom_hashes"], dd["fpr_theo"] * 100, "k--",
            label="theoretical")
    ax.set_xlabel("k (hash functions)")
    ax.set_ylabel("FPR [%]")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    print(f"wrote {out_png}")
    return out_png


def analyze(path: str):
    import pandas as pd

    df = pd.read_pickle(path)
    if "bloom_size" in df and df["bloom_filter"].ne("no").any():
        df = add_fpr(df)
        df = add_speedup(df)
        sup = brj_superiority(df)
    else:
        sup = None
    df["footprint"] = df["r_size"].map(footprint_class)
    out = path.replace(".pkl", "_analysis.md")
    cols = [c for c in ("algorithm", "r_size", "s_size", "selectivity",
                        "bloom_filter", "bloom_hashes", "nsec-per-tuple",
                        "filtered-pct", "fpr_emp", "fpr_theo", "speedup",
                        "footprint", "results") if c in df.columns]
    with open(out, "w") as f:
        f.write(df[cols].to_markdown(index=False))
        if sup is not None:
            f.write(f"\n\nbloom-superiority fraction: {sup:.3f}\n")
        bc = best_config_table(df, group_cols=("selectivity", "ratio", "q"))
        if bc is not None and len(bc):
            f.write("\n\n## best config per workload group\n\n")
            f.write(bc.to_markdown(index=False))
        fb = footprint_breakdown(df)
        if fb is not None and len(fb) > 1:
            f.write("\n\n## footprint classes (vs VMEM)\n\n")
            f.write(fb.to_markdown(index=False))
    if "fpr_emp" in df.columns:
        fpr_plot(df, path.replace(".pkl", "_fpr.png"))
    print(f"wrote {out}")
    return df


def _pickles() -> list[str]:
    """Sweep pickles under measurements/data/ (none before a sweep runs)."""
    if not os.path.isdir(DATA_DIR):
        return []
    return [os.path.join(DATA_DIR, p) for p in sorted(os.listdir(DATA_DIR))
            if p.endswith(".pkl")]


def cross_run_table():
    """Thesis cross-run summary (reference analysis.py cross_run:961-1005):
    one row per committed sweep — best config, throughput, prune rate."""
    import pandas as pd

    rows = []
    for path in _pickles():
        name = os.path.basename(path)
        df = pd.read_pickle(path)
        if "nsec-per-tuple" not in df:
            continue
        best = df.loc[df["nsec-per-tuple"].idxmin()]
        rows.append({
            "sweep": name[:-4],
            "configs": len(df),
            "best ns/tuple": round(float(best["nsec-per-tuple"]), 3),
            "best config": " ".join(
                f"{k}={best[k]}" for k in ("algorithm", "bloom_filter",
                                           "bloom_hashes", "devices")
                if k in best and best[k] not in (None, "no", 0, 1)),
            "results": int(best["results"]) if best["results"] else None,
        })
    out = pd.DataFrame(rows)
    if out.empty:
        print("no sweep pickles in measurements/data/ "
              "(run `python measurements/run.py <sweep>` first)")
        return out
    path = os.path.join(DATA_DIR, "cross_run.md")
    with open(path, "w") as f:
        f.write(out.to_markdown(index=False))
    print(out.to_markdown(index=False))
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "cross":
        cross_run_table()
    else:
        for p in sys.argv[1:] or _pickles():
            analyze(p)
