"""Test configuration: run everything on the CPU, with 8 virtual devices.

The suite runs where there is no GPU.  The join programs are plain jnp/lax,
so the numeric tests run them on XLA's CPU backend at small sizes, and the
sharding/collective tests use XLA's host-platform device partitioning.
Speed is measured only on the card (chip_smoke.py, bench.py), so the
persistent compilation cache stays off here.
"""

import os

# Pin the CPU before JAX initialises a backend: with a GPU present JAX
# would pick it, and the virtual mesh needs the host platform.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    import jax

    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs[:8]
