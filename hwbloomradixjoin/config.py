"""Runtime configuration.

The reference splits configuration across four levels (CLI getopt, autotools
-D defines, header constants rewritten + recompiled by measurements/config.py,
and runtime files).  Here everything is a runtime dataclass whose fields become
jit-static arguments — no recompilation of source, only XLA retraces.

Key parameters mirrored from the reference:
- bloom_filter_args_t {variant, m, k, B} (src/bloom_filter.h:52-57) -> BloomArgs
  with the reference CLI defaults m=256Mb, k=8, B=1024 (src/main.c:388-394)
"""

from __future__ import annotations

import dataclasses
import enum


class BloomVariant(enum.Enum):
    BASIC = "basic"
    BLOCKED = "blocked"


@dataclasses.dataclass(frozen=True)
class BloomArgs:
    """Bloom filter geometry (reference bloom_filter_args_t).

    m and B must be powers of two and m a multiple of B
    (assert_args, src/bloom_filter.c:25-34).
    """

    variant: BloomVariant = BloomVariant.BASIC
    m: int = 256 << 20  # filter size in bits
    k: int = 8          # probes per key
    B: int = 1024       # block size in bits (blocked variant)
    seed: int = 42      # filter hash seed (join_init_run uses 42,
                        # parallel_radix_join_bloom.c:1583)

    def __post_init__(self):
        if self.m & (self.m - 1):
            raise ValueError("m must be a power of 2")
        if self.variant == BloomVariant.BLOCKED:
            if self.B & (self.B - 1):
                raise ValueError("B must be a power of 2")
            if self.m % self.B:
                raise ValueError("m must be a multiple of B")

    @property
    def nblocks(self) -> int:
        return self.m // self.B


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration."""

    materialize: bool = False      # JOIN_RESULT_MATERIALIZE equivalent
    sync_stats: bool = False       # per-phase timing stats (SYNCSTATS analog)
