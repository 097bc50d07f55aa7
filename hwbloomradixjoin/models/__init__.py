"""Join algorithm families (the reference's algos[] registry, re-designed).

Reference algorithms (src/main.c:331-339):
    PRO, RJ, PRH, PRHO  — parallel radix joins (parallel_radix_join.c)
    NPO, NPO_st         — non-partitioned shared-table joins
and a bloom twin of each (BPRO/BRJ/BPRH/BPRHO, parallel_radix_join_bloom.c).

Every algorithm runs on the XLA tiers that models/registry.py selects from
properties of the input; distributed SPMD wrappers live in
hwbloomradixjoin/parallel/.
"""

from hwbloomradixjoin.models.registry import ALGORITHMS, run_join

__all__ = ["ALGORITHMS", "run_join"]
