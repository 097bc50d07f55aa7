"""Distributed hash join over a device mesh.

The reference's shared-memory "collectives" map onto real ones
(SURVEY.md §2.2):

    thread fan-out + barriers    -> one SPMD program under shard_map
    global histogram prefix-sums -> psum of per-device histograms
    shared scatter array         -> lax.all_to_all partition shuffle
    result sum (join_init_run)   -> psum of per-device counts
    NUMA-local task queues       -> static hash ownership: device d owns
                                    partition-hash range [d*F/D, (d+1)*F/D)

Bloom pre-filtering happens BEFORE the shuffle (the distributed analogue of
the reference pruning S during pass-1, parallel_radix_join_bloom.c:798-849):
the filter is built from local R shards, OR-combined across devices, and S
tuples failing it are dropped before any bytes cross the interconnect.

After the shuffle each device joins its hash range locally with the
single-device tiers' operators: the count table (ops/ht_join.py) when R's
key span fits HT_MAX_SLOTS, else the sort-scan.

Static-shape discipline: per-destination send buffers are capacity-padded
((D, cap) with PAD_KEY fill, one capacity per relation); `overflow` reports
dropped tuples so callers can re-run with a larger pad factor.  Skew-aware
repartitioning (heavy-hitter splitting) lives in parallel/skew.py.

Placement is separate from the step: `place` shards the columns once, and
`dist_join_count` reuses one compiled step per (mesh, shapes, options), so a
timed loop around it measures the join and not the host-to-device copy.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from hwbloomradixjoin.config import BloomArgs
from hwbloomradixjoin.ops import bloom as bloom_ops
from hwbloomradixjoin.ops import ht_join, xla_join
from hwbloomradixjoin.parallel.mesh import AXIS
from hwbloomradixjoin.types import Relation

PAD = jnp.int32(Relation.PAD_KEY)


def _dest_of(keys, n_dev: int):
    """Destination device: top log2(D) bits of the multiplicative hash."""
    bits = (n_dev - 1).bit_length()
    if n_dev == 1:
        return jnp.zeros(keys.shape, jnp.int32)
    h = xla_join.hash_multiplicative(keys, bits)
    return jnp.minimum(h, n_dev - 1)


def _pack_by_dest(dest, valid, cap: int, n_dev: int, *cols):
    """Group valid columns by destination into (D, cap) buffers (PAD filled).

    Deterministic: stable sort by destination (invalid tuples sort last and
    are silently dropped — they carry no data); valid tuples ranked past
    `cap` within their destination are dropped AND counted in overflow.
    """
    sort_key = jnp.where(valid, dest, jnp.int32(n_dev))
    order = jnp.argsort(sort_key, stable=True)
    d_s = sort_key[order]
    idx = jnp.arange(dest.shape[0], dtype=jnp.int32)
    boundary = jnp.concatenate([jnp.ones(1, bool), d_s[1:] != d_s[:-1]])
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, jnp.int32(-1)))
    pos = idx - seg_start
    keep = (pos < cap) & (d_s < n_dev)
    overflow = jnp.sum((pos >= cap) & (d_s < n_dev), dtype=jnp.int32)
    outs = []
    for c in cols:
        buf = jnp.full((n_dev, cap), PAD, dtype=c.dtype)
        buf = buf.at[d_s, pos].set(
            jnp.where(keep, c[order], PAD), mode="drop", unique_indices=True)
        outs.append(buf)
    return outs, overflow


def _or_across_devices(x, n_dev: int = 1):
    """Bitwise OR reduction across the mesh axis, shard-wise.

    A naive all_gather of the whole bitmap moves D*m bits to every device
    (8x128 MB at the reference geometry m=2^30) and peaks at D*m memory.
    Instead: reduce-scatter-style — all_to_all the bitmap in D shards so
    device d receives everyone's shard d (D * m/D bits in), ORs them locally,
    then all_gathers the reduced shards (m bits in).  Per-device traffic is
    ~2*m independent of D, memory peak ~2*m.  (OR has no psum primitive, so
    this is the collective-efficient formulation; the reference's analogue is
    the relaxed atomic fetch-or into one shared bitmap, bloom_filter.c:84.)
    """
    if n_dev == 1:
        return x
    words = x.shape[0]
    pad = (-words) % n_dev
    if pad:
        x = jnp.concatenate([x, jnp.zeros(pad, x.dtype)])
    shards = x.reshape(n_dev, -1)
    recv = jax.lax.all_to_all(shards, AXIS, 0, 0, tiled=False)  # (D, m/D)
    mine = jax.lax.reduce(recv, jnp.uint32(0), jax.lax.bitwise_or, (0,))
    full = jax.lax.all_gather(mine, AXIS).reshape(-1)
    return full[:words]


def _dist_join_step(rk, rp, sk, sp, n_dev: int, cap_r: int, cap_s: int,
                    bloom_args: Optional[BloomArgs], skew_handling: bool,
                    key_range):
    """Per-device SPMD body (runs under shard_map)."""
    s_after = jnp.int32(-1)
    if bloom_args is not None:
        local_bitmap = bloom_ops.build_bitmap_xla(rk, bloom_args)
        bitmap = _or_across_devices(local_bitmap, n_dev)
        mask = bloom_ops.probe_bitmap_xla(bitmap, sk, bloom_args)
        # padding slots (PAD key) must not count as survivors
        mask = mask & (sk != PAD)
        sk = jnp.where(mask, sk, PAD)
        s_after = jax.lax.psum(jnp.sum(mask, dtype=jnp.int32), AXIS)

    rd = _dest_of(rk, n_dev)
    sd = _dest_of(sk, n_dev)
    r_valid = rk != PAD
    s_valid = sk != PAD

    heavy_cnt = jnp.int32(0)
    rk_h = None
    if skew_handling and n_dev > 1:
        from hwbloomradixjoin.parallel import skew

        heavy = skew.heavy_dest_mask(sd, n_dev, valid=s_valid)
        salt = jnp.arange(sk.shape[0], dtype=jnp.int32) + \
            jax.lax.axis_index(AXIS).astype(jnp.int32)
        sd = skew.split_heavy_dests(sd, heavy, n_dev, salt)
        # R tuples bound for heavy destinations: replicate to every device
        # (broadcast join for the hot hash range) instead of normal routing.
        r_heavy = skew.replicate_mask_for_r(rd, heavy)
        (rk_hb, rp_hb), h_ovf = _pack_by_dest(
            jnp.zeros_like(rd), r_valid & r_heavy, cap_r, 1, rk, rp)
        rk_hg = jax.lax.all_gather(rk_hb[0], AXIS).reshape(-1)
        rp_hg = jax.lax.all_gather(rp_hb[0], AXIS).reshape(-1)
        rk_h = (rk_hg, rp_hg)
        r_valid = r_valid & ~r_heavy
        heavy_cnt = jax.lax.psum(h_ovf, AXIS)

    # PAD tuples (bloom-pruned / capacity padding) are dropped at pack
    # time — the point of pruning before the shuffle is that they cross
    # no wire.
    (rk_b, rp_b), r_ovf = _pack_by_dest(rd, r_valid, cap_r, n_dev, rk, rp)
    (sk_b, sp_b), s_ovf = _pack_by_dest(sd, s_valid, cap_s, n_dev, sk, sp)

    rk_x = jax.lax.all_to_all(rk_b, AXIS, 0, 0, tiled=False).reshape(-1)
    rp_x = jax.lax.all_to_all(rp_b, AXIS, 0, 0, tiled=False).reshape(-1)
    sk_x = jax.lax.all_to_all(sk_b, AXIS, 0, 0, tiled=False).reshape(-1)
    sp_x = jax.lax.all_to_all(sp_b, AXIS, 0, 0, tiled=False).reshape(-1)

    if rk_h is not None:
        rk_x = jnp.concatenate([rk_x, rk_h[0]])
        rp_x = jnp.concatenate([rp_x, rk_h[1]])

    if key_range is not None:
        # PAD lies below every key of the range, so padding never matches
        cnt, sr, ss = ht_join.counttable_join_count(rk_x, rp_x, sk_x, sp_x,
                                                    *key_range)
    else:
        # PAD rows on the R side must not join with PAD rows on the S side:
        # retag S pads to a second sentinel.
        sk_x = jnp.where(sk_x == PAD, PAD + 1, sk_x)
        cnt, sr, ss = xla_join.sort_scan_count(rk_x, rp_x, sk_x, sp_x)
    cnt = jax.lax.psum(cnt, AXIS)
    sr = jax.lax.psum(sr, AXIS)
    ss = jax.lax.psum(ss, AXIS)
    ovf = jax.lax.psum(r_ovf + s_ovf, AXIS) + heavy_cnt
    return cnt, sr, ss, s_after, ovf


@lru_cache(maxsize=8)
def _compiled_step(mesh, cap_r: int, cap_s: int,
                   bloom_args: Optional[BloomArgs], skew_handling: bool,
                   key_range):
    body = partial(_dist_join_step, n_dev=mesh.shape[AXIS], cap_r=cap_r,
                   cap_s=cap_s, bloom_args=bloom_args,
                   skew_handling=skew_handling, key_range=key_range)
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(), P(), P(), P(), P())))


def place(mesh, *cols):
    """Shard columns over the mesh's data axis; already-placed columns are
    returned as they are."""
    sh = NamedSharding(mesh, P(AXIS))

    def put(a):
        if isinstance(a, jax.Array) and a.sharding == sh:
            return a
        if jax.process_count() > 1:
            # multi-host: every process holds the (deterministically
            # generated) full array; each materializes only its
            # addressable shards (jax.distributed path, tools/dist_multiproc)
            import numpy as np
            a = np.asarray(a)
            return jax.make_array_from_callback(
                a.shape, sh, lambda idx: a[idx])
        return jax.device_put(a, sh)

    return [put(a) for a in cols]


def dist_join_count(mesh, rk, rp, sk, sp,
                    bloom_args: Optional[BloomArgs] = None,
                    pad_factor: float = 2.0, skew_handling: bool = False,
                    key_range=None):
    """Distributed join count over `mesh` (inputs sharded on axis "d").

    Returns (count, sum_rpay, sum_spay, s_after_filter, overflow); overflow>0
    means the capacity pad was too small for the hash skew — results are then
    invalid and the caller should retry with a larger pad_factor (or enable
    skew_handling, which splits heavy destinations).

    key_range=(lo, hi), R's key range, selects the count-table local join
    when its span fits HT_MAX_SLOTS; otherwise the sort-scan joins locally.
    Columns not yet placed are placed first (see `place`).
    """
    from hwbloomradixjoin.models.registry import HT_MAX_SLOTS

    n_dev = mesh.shape[AXIS]
    cap_r = int(rk.shape[0] / n_dev / n_dev * pad_factor) + 16
    cap_s = int(sk.shape[0] / n_dev / n_dev * pad_factor) + 16
    if key_range is not None:
        key_range = (int(key_range[0]), int(key_range[1]))
        if key_range[1] - key_range[0] + 1 > HT_MAX_SLOTS:
            key_range = None
    step = _compiled_step(mesh, cap_r, cap_s, bloom_args, skew_handling,
                          key_range)
    return step(*place(mesh, rk, rp, sk, sp))
