"""Vectorized host reference for joins whose build keys are unique.

`native.ref_join` walks a std::unordered_map one tuple at a time, which takes
minutes at a billion probe tuples.  For a unique R key column `lookup_join`
computes the same three numbers with numpy: a direct-address table over R's
key span maps each key to its row, and S is probed in chunks.  The result is
exact and equal to `native.ref_join` on such inputs (payloads summed as
uint32 values, mod 2^64).
"""

from __future__ import annotations

import numpy as np

# direct-address table budget: one int32 row index per slot of R's span
MAX_SPAN = 1 << 30
CHUNK = 1 << 25


class _RowTable:
    """Key -> R row over R's key span; -1 for keys R does not hold."""

    def __init__(self, rk):
        rk = np.asarray(rk)
        self.lo, hi = int(rk.min()), int(rk.max())
        self.span = hi - self.lo + 1
        if self.span > MAX_SPAN:
            raise ValueError(f"R key span {self.span} exceeds {MAX_SPAN}")
        self.row = np.full(self.span, -1, np.int32)
        self.row[rk.astype(np.int64) - self.lo] = np.arange(rk.shape[0],
                                                            dtype=np.int32)
        if np.count_nonzero(self.row >= 0) != rk.shape[0]:
            raise ValueError("R keys are not unique")

    def probe(self, keys):
        s = np.asarray(keys).astype(np.int64) - self.lo
        inside = (s >= 0) & (s < self.span)
        out = np.full(s.shape[0], -1, np.int32)
        out[inside] = self.row[s[inside]]
        return out


def matched_rows(rk, sk):
    """For a unique R: the R row matching each S row, -1 where none."""
    table = _RowTable(rk)
    return np.concatenate([table.probe(sk[i:i + CHUNK])
                           for i in range(0, len(sk), CHUNK)])


def lookup_join(rk, rp, sk, sp):
    """(count, sum of matched R payloads, sum of matched S payloads).

    Sums are mod 2^64 of the payloads read as uint32, as in
    `native.ref_join`.  Raises ValueError if R's keys are not unique or
    their span exceeds MAX_SPAN.
    """
    table = _RowTable(rk)
    rpay = np.asarray(rp).astype(np.uint32).astype(np.uint64)
    count, sum_r, sum_s = 0, np.uint64(0), np.uint64(0)
    for i in range(0, len(sk), CHUNK):
        r_of = table.probe(sk[i:i + CHUNK])
        hit = r_of >= 0
        count += int(np.count_nonzero(hit))
        sum_r += rpay[r_of[hit]].sum(dtype=np.uint64)
        sum_s += np.asarray(sp[i:i + CHUNK])[hit].astype(np.uint32) \
            .astype(np.uint64).sum(dtype=np.uint64)
    return count, int(sum_r), int(sum_s)
