"""Config-file-driven run mode (the Wisconsin `multijoin <conf>` capability).

The reference's secondary engine is driven by libconfig files describing
tables, partitioners, and the joiner (wisconsin-src/main.cpp:169-417,
conf/*.conf).  Here the same capability is a small declarative config:

    {
      "algorithm": "PRO",            // RJ PRO PRH PRHO NPO NPO_st
      "threads": 8,                  // generator layout parity
      "build":  {"size": 1000000, "seed": 12345,
                 "file": null},      // or {"file": "R.tbl", "size": N}
      "probe":  {"size": 8000000, "seed": 54321, "selectivity": 1.0,
                 "skew": 0.0, "file": null},
      "bloom":  {"variant": "blocked", "m": 1073741824, "k": 1, "B": 512},
      "engine": {"backend": "gpu"},  // or "cpu"
      "repeats": 1
    }

Accepts JSON and a libconfig-ish `key = value;` subset (flattened with
dotted keys).  Output: the same timing block + "RUNTIME TOTAL ..." lines as
the CLI, plus cycles-style summary lines matching the Wisconsin output shape
("RUNTIME TOTAL, BUILD+PART, PART (cycles):").

Usage: python -m hwbloomradixjoin.confrun <conf-file>
"""

from __future__ import annotations

import json
import re
import sys


def parse_conf(text: str) -> dict:
    """Parse JSON, or a flat libconfig-like `a.b = value;` list."""
    text_stripped = text.strip()
    if text_stripped.startswith("{"):
        return json.loads(text)
    conf: dict = {}
    for line in text.splitlines():
        line = line.split("//")[0].split("#")[0].strip().rstrip(";")
        if not line or "=" not in line:
            continue
        key, val = [x.strip() for x in line.split("=", 1)]
        val = val.strip('"')
        if re.fullmatch(r"-?\d+", val):
            val = int(val)
        elif re.fullmatch(r"-?\d*\.\d+", val):
            val = float(val)
        elif val in ("true", "false"):
            val = val == "true"
        node = conf
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return conf


def run_config(conf: dict) -> int:
    from hwbloomradixjoin.config import BloomArgs, BloomVariant, EngineConfig
    from hwbloomradixjoin.data import generator as G
    from hwbloomradixjoin.data import tblio
    from hwbloomradixjoin.models import run_join
    from hwbloomradixjoin.types import Relation
    from hwbloomradixjoin.utils.timing import print_timing

    from hwbloomradixjoin import runtime

    runtime.setup_compile_cache()
    runtime.select_backend(conf.get("engine", {}).get("backend", "gpu"))

    build = conf.get("build", {})
    probe = conf.get("probe", {})
    params = G.WorkloadParams(
        r_size=build.get("size", 128_000_000),
        s_size=probe.get("size", 128_000_000),
        r_seed=build.get("seed", 12345),
        s_seed=probe.get("seed", 54321),
        nthreads=conf.get("threads", 2),
        skew=probe.get("skew", 0.0),
        selectivity=probe.get("selectivity", 1.0),
    )
    if build.get("file"):
        rk, rp = tblio.read_relation(build["file"], build.get("size"))
        sk, sp = tblio.read_relation(probe["file"], probe.get("size"))
        stats = None
    else:
        rk, rp, sk, sp = G.build_workload(params)
        stats = G.r_key_stats(params)

    bloom_args = None
    if conf.get("bloom"):
        b = conf["bloom"]
        bloom_args = BloomArgs(variant=BloomVariant(b.get("variant", "basic")),
                               m=b.get("m", 256 << 20), k=b.get("k", 8),
                               B=b.get("B", 1024))

    cfg = EngineConfig()

    R = Relation.from_numpy(rk, rp, stats=stats)
    S = Relation.from_numpy(sk, sp)
    algo = conf.get("algorithm", "PRO")
    best = None
    for _ in range(conf.get("repeats", 1)):
        result, st, _ = run_join(algo, R, S, cfg, bloom_args)
        if best is None or st.total_usec < best[1].total_usec:
            best = (result, st)
    result, st = best
    print_timing(st)
    # Wisconsin-style summary line (main.cpp:411 prints cycles triple)
    total_ns = int(st.total_usec * 1000)
    part_ns = int(st.part_usec * 1000)
    print(f"RUNTIME TOTAL, BUILD+PART, PART (cycles): "
          f"{total_ns} {int(st.build_usec*1000) + part_ns} {part_ns}")
    print(f"[INFO ] Results = {result.count()}. DONE.")
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m hwbloomradixjoin.confrun <conf-file>")
        return 2
    with open(argv[0]) as f:
        conf = parse_conf(f.read())
    return run_config(conf)


if __name__ == "__main__":
    sys.exit(main())
