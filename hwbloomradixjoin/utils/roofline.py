"""Published peaks of the accelerators the engine runs on.

The reference attributes cycles to memory levels with perf_event/Intel PCM
(src/perf_manager.c, src/perf_counters.c); here a kernel's roofline share is
the least time its bytes need at the card's published memory bandwidth over
its time in the profiler trace.  The table is keyed by JAX's `device_kind`;
a device that is not in it is an error, never a default.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipModel:
    name: str
    hbm_gbps: float          # device-memory bandwidth, GB/s
    hbm_gb: int              # device memory, GB
    source: str


CHIPS = {
    "NVIDIA H100 80GB HBM3": ChipModel(
        "H100 SXM", 3350.0, 80,
        "NVIDIA H100 Tensor Core GPU data sheet, SXM: 3.35 TB/s HBM3, 80 GB"),
}


def chip_model(device=None) -> ChipModel:
    """Peaks of `device` (default: JAX's first device)."""
    if device is None:
        import jax
        device = jax.devices()[0]
    kind = device.device_kind
    if kind not in CHIPS:
        raise ValueError(f"no published peaks for device_kind {kind!r}; "
                         "add its row to utils/roofline.CHIPS with a source")
    return CHIPS[kind]
