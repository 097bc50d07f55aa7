"""Experiment configuration for the sweep harness.

Parity with the reference's measurements/config.py: JoinConfig dataclass ->
CLI arguments (reference config.py:14-87).  Two structural differences:

- No source patching + recompiling: the reference rewrites prj_params.h and
  cpu_mapping.c then re-runs autotools per configuration
  (set_prj_params:280-312, set_cpu_constant:315-329).  The engine has no
  radix-bits or pass-count knobs to patch: its tiers follow the input.
- No cpu-mapping.txt thread-placement files: device placement is the mesh.
  The `threads` field feeds the generator's layout parity only.
"""

from __future__ import annotations

import dataclasses
import shlex


@dataclasses.dataclass
class JoinConfig:
    algorithm: str = "PRO"
    threads: int = 8
    r_size: int = 1_000_000
    s_size: int = 8_000_000
    r_seed: int = 12345
    s_seed: int = 54321
    selectivity: float = 1.0
    skew: float = 0.0
    bloom_filter: str = "no"          # no | basic | blocked
    bloom_size: int = 1 << 30         # m bits
    bloom_hashes: int = 1             # k
    bloom_block_size: int = 512       # B bits
    non_unique: bool = False
    full_range: bool = False
    backend: str = "gpu"              # gpu | cpu
    repeats: int = 1
    inner: int = 1                    # warmed executions (--engine-inner)
    devices: int = 0                  # dist mesh size (0 = local engine)

    def to_args(self) -> list[str]:
        args = [
            "-a", self.algorithm,
            "-n", str(self.threads),
            "-r", str(self.r_size),
            "-s", str(self.s_size),
            "-x", str(self.r_seed),
            "-y", str(self.s_seed),
            "-q", str(self.selectivity),
            "-z", str(self.skew),
        ]
        if self.bloom_filter != "no":
            args += ["-b", self.bloom_filter, "-m", str(self.bloom_size),
                     "-k", str(self.bloom_hashes),
                     "-B", str(self.bloom_block_size)]
        if self.non_unique:
            args.append("--non-unique")
        if self.full_range:
            args.append("--full-range")
        if self.devices >= 1:
            args += ["--engine-devices", str(self.devices)]
        if self.backend != "gpu":
            args += ["--engine-backend", self.backend]
        if self.repeats > 1:
            args += ["--engine-repeats", str(self.repeats)]
        if self.inner > 1:
            args += ["--engine-inner", str(self.inner)]
        return args

    def cmdline(self) -> str:
        return shlex.join(["python", "-m", "hwbloomradixjoin.cli"]
                          + self.to_args())
