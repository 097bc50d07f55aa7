"""Profiler capture — jax.profiler traces replacing rdtsc/perf_event tiers.

The reference's three observability tiers (SURVEY.md §5: rdtsc phase timers,
SYNCSTATS barrier-wait stats, hardware counters) map to:
  phase timers   -> per-phase programs timed to block_until_ready
                    (models/registry.py) + this module's device trace
  syncstats      -> per-device step timing from the trace (imbalance view)
  perf counters  -> device kernel times from the trace
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a jax.profiler trace into logdir around a region (view with
    xprof/tensorboard); logdir None captures nothing."""
    if logdir is None:
        yield None
        return
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace region (shows up in the device timeline)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
