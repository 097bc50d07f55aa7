"""Distributed SPMD join on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from hwbloomradixjoin.config import BloomArgs, BloomVariant
from hwbloomradixjoin.data import generator as G
from hwbloomradixjoin.data import native
from hwbloomradixjoin.parallel import dist_join, mesh as mesh_lib


@pytest.fixture(scope="module")
def workload():
    p = G.WorkloadParams(r_size=8_192, s_size=32_768, nthreads=4,
                         selectivity=0.4)
    rk, rp, sk, sp = G.build_workload(p)
    return rk, rp, sk, sp, native.ref_join(rk, rp, sk, sp)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_count_matches_ground_truth(eight_devices, workload, n_dev):
    rk, rp, sk, sp, want = workload
    mesh = mesh_lib.make_mesh(n_dev)
    cnt, sr, ss, s_after, ovf = dist_join.dist_join_count(mesh, rk, rp, sk, sp)
    assert int(ovf) == 0
    assert int(cnt) == want[0]
    assert int(sr) == want[1] % 2**32 and int(ss) == want[2] % 2**32
    assert int(s_after) == -1


def test_dist_bloom_prunes_before_shuffle(eight_devices, workload):
    rk, rp, sk, sp, want = workload
    mesh = mesh_lib.make_mesh(8)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 18, k=2, B=512)
    cnt, sr, ss, s_after, ovf = dist_join.dist_join_count(
        mesh, rk, rp, sk, sp, bloom_args=args)
    assert int(ovf) == 0
    assert int(cnt) == want[0]
    assert want[0] <= int(s_after) < sk.shape[0]


def test_dist_zipf_skew_handling(eight_devices):
    """replicate-R/split-S keeps exact counts with a small pad factor."""
    p = G.WorkloadParams(r_size=2_048, s_size=16_384, nthreads=2, skew=1.0)
    rk, rp, sk, sp = G.build_workload(p)
    want = native.ref_join(rk, rp, sk, sp)
    mesh = mesh_lib.make_mesh(8)
    cnt, sr, ss, _, ovf = dist_join.dist_join_count(
        mesh, rk, rp, sk, sp, pad_factor=3.0, skew_handling=True)
    assert int(ovf) == 0
    assert int(cnt) == want[0] == 16_384
    assert int(sr) == want[1] % 2**32 and int(ss) == want[2] % 2**32


def test_dist_zipf_skew(eight_devices):
    # z=1.0 probe-side skew: heavy keys all land on one device's partition;
    # generous pad absorbs it (dedicated skew splitting in parallel/skew.py)
    p = G.WorkloadParams(r_size=2_048, s_size=16_384, nthreads=2, skew=1.0)
    rk, rp, sk, sp = G.build_workload(p)
    want = native.ref_join(rk, rp, sk, sp)
    mesh = mesh_lib.make_mesh(8)
    cnt, sr, ss, _, ovf = dist_join.dist_join_count(
        mesh, rk, rp, sk, sp, pad_factor=16.0)
    assert int(ovf) == 0
    assert int(cnt) == want[0] == 16_384


def test_multiprocess_distributed_cpu():
    """Real jax.distributed: 2 coordinator-connected CPU processes, 4
    global devices, exact count + checksums (tools/dist_multiproc.py).
    Exercises mesh.init_distributed — the multi-host wiring path."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "dist_multiproc.py")],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIPROC PASS" in proc.stdout


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dist_count_table_local_join(eight_devices, workload, n_dev):
    """With R's key range declared, each device joins its hash range on a
    count table: exact count and both checksums."""
    rk, rp, sk, sp, want = workload
    mesh = mesh_lib.make_mesh(n_dev)
    cnt, sr, ss, s_after, ovf = dist_join.dist_join_count(
        mesh, rk, rp, sk, sp, key_range=(1, 8_192))
    assert int(ovf) == 0
    assert int(cnt) == want[0]
    assert int(sr) == want[1] % 2**32 and int(ss) == want[2] % 2**32


def test_dist_count_table_with_bloom_prune(eight_devices, workload):
    rk, rp, sk, sp, want = workload
    mesh = mesh_lib.make_mesh(4)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 20, k=2, B=512)
    cnt, sr, ss, s_after, ovf = dist_join.dist_join_count(
        mesh, rk, rp, sk, sp, bloom_args=args, key_range=(1, 8_192))
    assert int(ovf) == 0
    assert int(cnt) == want[0]
    assert int(sr) == want[1] % 2**32 and int(ss) == want[2] % 2**32
    want_after = int(native.ref_bloom("blocked", args.m, args.k, args.B,
                                      args.seed, rk, sk).sum())
    assert int(s_after) == want_after


def test_dist_place_once_then_step(eight_devices, workload):
    """Placement is separate from the step: placed columns are reused as
    they are, and repeated calls reuse one compiled step."""
    rk, rp, sk, sp, want = workload
    mesh = mesh_lib.make_mesh(4)
    cols = dist_join.place(mesh, rk, rp, sk, sp)
    assert all(a is b for a, b in zip(dist_join.place(mesh, *cols), cols))
    before = dist_join._compiled_step.cache_info().hits
    for _ in range(2):
        cnt = dist_join.dist_join_count(mesh, *cols, key_range=(1, 8_192))[0]
        assert int(cnt) == want[0]
    assert dist_join._compiled_step.cache_info().hits >= before + 1


def test_dist_wide_key_range_joins_by_sort(eight_devices, workload):
    """A key span past HT_MAX_SLOTS falls back to the sort-scan local join."""
    from hwbloomradixjoin.models.registry import HT_MAX_SLOTS

    rk, rp, sk, sp, want = workload
    mesh = mesh_lib.make_mesh(2)
    cnt, sr, ss, _, ovf = dist_join.dist_join_count(
        mesh, rk, rp, sk, sp, key_range=(0, HT_MAX_SLOTS))
    assert int(ovf) == 0 and int(cnt) == want[0]
    assert int(sr) == want[1] % 2**32 and int(ss) == want[2] % 2**32
