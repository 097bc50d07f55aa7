"""Entry-point set-up: device choice, compile cache, published peaks,
and the exact host reference."""

import os
import types

import jax
import numpy as np
import pytest

from hwbloomradixjoin import runtime
from hwbloomradixjoin.data import native, reference
from hwbloomradixjoin.utils import roofline


def test_select_backend_gpu_raises_without_gpu():
    with pytest.raises(RuntimeError, match="backend 'gpu'"):
        runtime.select_backend("gpu")


def test_select_backend_cpu_explicit():
    devs = runtime.select_backend("cpu")
    assert devs[0].platform == "cpu"


def test_select_backend_rejects_unknown():
    with pytest.raises(ValueError):
        runtime.select_backend("auto")


@pytest.fixture
def cache_dir_restored():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_is_used(monkeypatch, tmp_path, cache_dir_restored):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == os.path.join(runtime.ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(runtime.ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_device_summary_names_platform_kind_count(eight_devices):
    d = runtime.device_summary()
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


def test_nvidia_smi_absent(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert runtime.nvidia_smi_line().startswith("nvidia-smi unavailable")
    assert runtime.sm_clock_mhz() is None


def test_roofline_h100_row():
    dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    chip = roofline.chip_model(dev)
    assert chip.hbm_gbps == 3350.0 and chip.hbm_gb == 80
    assert "data sheet" in chip.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H200"])
def test_roofline_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.chip_model(types.SimpleNamespace(device_kind=kind))


@pytest.mark.parametrize("lo,span,n_r,n_s", [
    (1, 5000, 5000, 40000),          # dense primary key
    (-3000, 1 << 20, 4000, 30000),   # sparse, negative keys
    (7, 64, 1, 1000),                # one build tuple
])
def test_lookup_join_equals_native(lo, span, n_r, n_s):
    rng = np.random.default_rng(span)
    rk = (rng.choice(span, n_r, replace=False) + lo).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, n_r).astype(np.int32)
    sk = (rng.integers(-span, 2 * span, n_s) + lo).astype(np.int32)
    sp = rng.integers(-2**31, 2**31, n_s).astype(np.int32)
    assert reference.lookup_join(rk, rp, sk, sp) == \
        native.ref_join(rk, rp, sk, sp)
    rows = reference.matched_rows(rk, sk)
    hit = rows >= 0
    assert np.array_equal(rk[rows[hit]], sk[hit])
    assert not np.isin(sk[~hit], rk).any()


def test_lookup_join_refuses_duplicates_and_wide_spans():
    with pytest.raises(ValueError, match="not unique"):
        reference.lookup_join(np.array([3, 3], np.int32),
                              np.zeros(2, np.int32),
                              np.array([3], np.int32), np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="span"):
        reference.lookup_join(np.array([0, 2**31 - 1], np.int32),
                              np.zeros(2, np.int32),
                              np.array([3], np.int32), np.zeros(1, np.int32))
