"""Phase timing and mchashjoins-compatible stdout formatting.

The reference prints a fixed 3-line timing block (print_timing,
src/parallel_radix_join_bloom.c:1509-1547 / no_partitioning_join.c:334-356)
plus "[INFO ] ..." status lines that measurements/run.py regex-parses
(parse_result, run.py:100-156).  The engine emits the identical line formats
so that harness tooling works unchanged against either binary.

On the "cycles" fields: the reference reports rdtsc cycles; device programs
have no host-tsc equivalent spanning their execution, so the engine reports
nanoseconds in those fields (same magnitude role: total/build/partition).
The harness only compares these relatively.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class JoinStats:
    total_usec: float = 0.0
    build_usec: float = 0.0
    part_usec: float = 0.0
    probe_usec: float = 0.0
    result: int = 0
    num_s_tuples: int = 0
    s_after_filter: int | None = None
    compile_usec: float = 0.0
    tier: str = ""                 # execution tier chosen by the planner
    prune_usec: float = 0.0        # bloom prune, timed as its own program
    num_r_tuples: int = 0
    memory_analysis: object = None  # compiled join program's memory stats

    @property
    def nsec_per_tuple(self) -> float:
        if not self.num_s_tuples:
            return 0.0
        return self.total_usec * 1000.0 / self.num_s_tuples


def print_sync_stats(stats: JoinStats, phase_usec: dict[str, float]) -> None:
    """SYNCSTATS analogue: per-phase device time table.

    The reference's --enable-syncstats dumps per-thread barrier-wait spans
    (parallel_radix_join_bloom.c:1710-1728); the deterministic SPMD engine
    has no waits, so the equivalent diagnostic is the per-phase dispatch
    breakdown plus the fused-vs-sum overhead.
    """
    print(f"[SYNC] tier={stats.tier} fused_total={stats.total_usec:.1f}us")
    tot = 0.0
    for name, us in phase_usec.items():
        print(f"[SYNC]   phase {name:8s} {us:12.1f} us")
        tot += us
    if tot:
        print(f"[SYNC]   phase-sum {tot:12.1f} us "
              f"(fusion gain {tot - stats.total_usec:+.1f} us)")


def print_timing(stats: JoinStats) -> str:
    """Render the reference's timing block; returns the string (also printed)."""
    lines = []
    if stats.s_after_filter is not None:
        lines.append(f"S-tuples after filter: {stats.s_after_filter}")
    lines.append("RUNTIME TOTAL, BUILD, PART (cycles): ")
    lines.append(f"{int(stats.total_usec * 1000)} \t {int(stats.build_usec * 1000)}"
                 f" \t {int(stats.part_usec * 1000)} ")
    lines.append("TOTAL-TIME-USECS, TOTAL-TUPLES, NSEC-PER-TUPLE: ")
    lines.append(f"{stats.total_usec:.4f} \t {stats.result} \t {stats.nsec_per_tuple:.4f} ")
    lines.append("PARTITION-TIME-USECS, PROBE-TIME-USECS, JOIN-TIME-USECS: ")
    # phase times come from extra synced dispatches and carry their own
    # measurement noise; the derived join time is clamped non-negative so
    # the block always parses (reference format has no sign)
    join_usec = max(stats.total_usec - stats.part_usec, 0.0)
    lines.append(f"{stats.part_usec:.4f} \t {stats.probe_usec:.4f}\t "
                 f"{join_usec:.4f} ")
    out = "\n".join(lines)
    print(out)
    return out
