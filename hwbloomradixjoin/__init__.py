"""hwbloomradixjoin — a vectorized hash-join engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
Briimbo/HwBloomRadixJoin reference suite (hardware-conscious bloom filters for
join acceleration, extending the ETH "mchashjoins" radix-join package),
running on an NVIDIA GPU (or the CPU, for validation):

- the reference's join algorithms (PRO/PRH/PRHO/RJ and NPO/NPO_st) served by
  a count-table tier and sort-based tiers that XLA compiles
- hardware-conscious bloom filters (basic + register-blocked) with exact
  reference hash math (CrapWow, CRC32-C, enhanced double hashing) fused into
  the join program to prune probe-side tuples early
- radix sort and hash aggregation operators
- deterministic data generators matching the reference key populations
  (threshold-selectivity PK, FK tiling, Zipf)
- SPMD multi-device execution over a jax.sharding.Mesh: psum histogram
  exchange, all-to-all hash-partition shuffle, skew-aware repartitioning

Where the reference uses pthreads + NUMA-local task queues + per-bucket
latches (src/parallel_radix_join.c, src/task_queue.h, src/lock.h), this build
uses deterministic SPMD programs: static histogram-driven partition ownership,
XLA collectives, and race-free scatter formulations.
"""

__version__ = "0.1.0"

from hwbloomradixjoin.types import Relation, JoinResult, key_dtype
from hwbloomradixjoin.config import BloomArgs, BloomVariant, EngineConfig

__all__ = [
    "Relation",
    "JoinResult",
    "key_dtype",
    "BloomArgs",
    "BloomVariant",
    "EngineConfig",
]
