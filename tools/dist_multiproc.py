"""Real multi-process jax.distributed validation of the distributed tier.

This tool launches N coordinator-connected CPU processes (each with its
own local devices), builds the global mesh spanning all of them, runs
dist_join_count through the same shard_map program as single-process, and
asserts the exact count + checksums on process 0 — the coordinator wiring
path that a multi-host deployment uses, minus the hardware (zero code
differences: parallel/mesh.init_distributed -> jax.distributed).

Usage:
  python tools/dist_multiproc.py            # parent: spawn 2 procs, check
  python tools/dist_multiproc.py --procs 4  # 4 processes x 2 devices
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEVS_PER_PROC = 2


def child() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    # distributed init MUST precede any backend-touching call — including
    # engine imports that build jit wrappers — so run it first thing
    from hwbloomradixjoin.parallel import mesh as mesh_lib

    assert mesh_lib.init_distributed(), "HBRJ_* env missing"
    import numpy as np

    from hwbloomradixjoin.config import BloomArgs, BloomVariant
    from hwbloomradixjoin.data import native
    from hwbloomradixjoin.parallel import dist_join
    nproc = jax.process_count()
    pid = jax.process_index()
    n_dev = len(jax.devices())
    print(f"[proc {pid}] {nproc} processes, {n_dev} global devices",
          flush=True)
    assert nproc == int(os.environ["HBRJ_NUM_PROCS"])
    assert n_dev == nproc * DEVS_PER_PROC

    # identical deterministic workload on every process
    rng = np.random.default_rng(33)
    n_r, n_s = 1 << 13, 1 << 15
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int32)
    rp = np.arange(n_r, dtype=np.int32)
    sk = rng.integers(1, 3 * n_r, n_s).astype(np.int32)
    sp = np.arange(n_s, dtype=np.int32)

    mesh = mesh_lib.make_mesh(n_dev)
    bloom_args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 16, k=2,
                           B=512)
    cnt, sr, ss, s_after, ovf = dist_join.dist_join_count(
        mesh, rk, rp, sk, sp, bloom_args=bloom_args)
    want, want_sr, want_ss = native.ref_join(rk, rp, sk, sp)
    assert int(ovf) == 0, f"overflow {int(ovf)}"
    assert int(cnt) == want, f"{int(cnt)} != {want}"
    assert int(sr) == want_sr % 2**32 and int(ss) == want_ss % 2**32
    print(f"[proc {pid}] DIST-OK count={int(cnt)} "
          f"s_after={int(s_after)}", flush=True)
    return 0


def parent(nproc: int) -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for i in range(nproc):
        env = dict(os.environ)
        env.update({
            "HBRJ_COORDINATOR": f"127.0.0.1:{port}",
            "HBRJ_NUM_PROCS": str(nproc),
            "HBRJ_PROC_ID": str(i),
            "HBRJ_CHILD": "1",
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count="
                         f"{DEVS_PER_PROC}",
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    rc = 0
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            rc = 1
        print(f"--- proc {i} (rc={p.returncode}) ---\n{out}")
        if p.returncode != 0 or "DIST-OK" not in out:
            rc = 1
    print("MULTIPROC", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    if os.environ.get("HBRJ_CHILD"):
        sys.exit(child())
    n = 2
    if "--procs" in sys.argv:
        n = int(sys.argv[sys.argv.index("--procs") + 1])
    sys.exit(parent(n))
