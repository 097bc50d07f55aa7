"""Process set-up shared by every entry point: compile cache and device.

Entry points (the CLI, `confrun`, `bench.py`, `chip_smoke.py`) call
`setup_compile_cache()` first and then `select_backend()`, so the platform
decision is made in one place:

- "gpu" (the default) requires JAX's first device to be a GPU and raises
  otherwise; it never continues on the CPU.
- "cpu" pins JAX to the host, for validation runs and tests.
"""

from __future__ import annotations

import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed, in-checkout, listed in .gitignore: the path is part of the cache
# key, so it must not move between runs
DEFAULT_CACHE_DIR = os.path.join(ROOT, ".jax_cache")

BACKENDS = ("gpu", "cpu")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is used as it is (JAX reads it
    itself); otherwise the cache lives in `.jax_cache/` of the checkout.
    Returns the directory in use.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def select_backend(backend: str = "gpu"):
    """Make the platform decision; returns `jax.devices()`.

    Must run before the first JAX computation of the process: the CPU
    choice only takes effect while no backend is initialised yet.
    """
    import jax

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    devs = jax.devices()
    if backend == "gpu" and devs[0].platform != "gpu":
        raise RuntimeError(
            f"backend 'gpu' requested but JAX's first device is "
            f"{devs[0].platform!r} ({devs[0].device_kind}); pass 'cpu' to "
            "run on the host")
    return devs


def nvidia_smi_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card.

    The power limit belongs beside every number taken on the card: a card
    set below its maximum runs slower under load.
    """
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi printed nothing"


def sm_clock_mhz() -> float | None:
    """The first card's current SM clock in MHz; None if unreadable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_summary() -> dict:
    """Platform, device kind and count of JAX's devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
