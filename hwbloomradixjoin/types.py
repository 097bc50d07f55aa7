"""Core table types: columnar relations and join results.

The reference (src/types.h:37-63) stores row-major ``tuple_t {key, payload}``
arrays.  A vectorized engine wants columnar layout: a relation is a pair of dense
device arrays (``key[n]``, ``payload[n]``), int32 by default or int64 with
``key8b`` (the reference's --enable-key8B / KEY_8B switch, src/types.h:22-28).

Columnar layout means every operator streams contiguous key columns with no
interleaving waste, and payload columns ride along only when needed.

``KeyStats`` carries declared key constraints (key range, PRIMARY KEY), set
by construction when the generators build PK relations — the planner sizes
the count table from the range and materializes unique builds without a
pre-count, the same way disk-based engines exploit declared primary keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def key_dtype(key8b: bool = False):
    """Key/payload dtype: int32 (8B tuples) or int64 (16B tuples, KEY_8B)."""
    return jnp.int64 if key8b else jnp.int32


@dataclasses.dataclass(frozen=True)
class KeyStats:
    """Declared key metadata (constraint-grade, set by construction).

    The generator guarantees both fields for PK relations
    (parallel_create_relation with selectivity 1.0 emits each key in [1, n]
    exactly once, generator.c:161-221).
    """

    min_key: int
    max_key: int
    is_unique: bool = False        # keys declared unique (PRIMARY KEY)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Relation:
    """A columnar relation: parallel key/payload arrays.

    Mirrors the capability of relation_t (src/types.h:46-49).  ``num_valid``
    supports capacity-padded relations (needed because XLA requires static
    shapes: filtered/partitioned relations keep their allocated capacity and a
    dynamic count of live tuples; padding slots hold PAD_KEY).
    """

    key: jax.Array
    payload: jax.Array
    # KEY_8B mode (src/types.h:22-28): 64-bit keys ride as two int32 columns
    # (key = high word, carried here; `key` holds the low word).  None = 32-bit.
    key_hi: Optional[jax.Array] = None
    # KEY_8B also widens value_t to int64 (src/types.h:22-28): the payload's
    # high word rides here (payload holds the low word); None = 32-bit.
    payload_hi: Optional[jax.Array] = None
    # dynamic number of valid tuples (scalar array); tuples beyond are padding
    num_valid: Optional[jax.Array] = None
    # static declared key constraints (not traced)
    stats: Optional[KeyStats] = dataclasses.field(
        default=None, metadata=dict(static=True))

    # Padding sentinel: the reference generators only produce keys >= 0
    # (generator.c:161-221 cycles keys in [1, threshold]; genzipf.c:39 "don't
    # let 0 be in the alphabet"), so INT32_MIN never collides with a live key.
    PAD_KEY = np.int32(-2147483648)

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def num_tuples(self):
        if self.num_valid is None:
            return self.key.shape[0]
        return self.num_valid

    @property
    def dtype(self):
        return self.key.dtype

    @staticmethod
    def from_numpy(key: np.ndarray, payload: Optional[np.ndarray] = None,
                   device=None, stats: Optional[KeyStats] = None,
                   key8b: bool = False) -> "Relation":
        """Build a device relation; key8b splits int64 keys into hi/lo columns.

        With key8b the input key array (any integer dtype) is widened to
        int64 and carried as two int32 columns — the columnar KEY_8B layout
        (16B tuples: key_hi, key_lo, payload, and an implied payload_hi of 0;
        reference tuple_t with intkey_t=int64_t, src/types.h:22-40).
        """
        if payload is None:
            payload = np.arange(key.shape[0], dtype=np.int32)
        phi = None
        if key8b:
            k64 = np.asarray(key, dtype=np.int64)
            k = jnp.asarray((k64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
            khi = jnp.asarray((k64 >> 32).astype(np.int32))
            p64 = np.asarray(payload, dtype=np.int64)
            p = jnp.asarray((p64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
            phi = jnp.asarray((p64 >> 32).astype(np.int32))
        else:
            k = jnp.asarray(key)
            khi = None
            p = jnp.asarray(payload)
        if device is not None:
            k = jax.device_put(k, device)
            p = jax.device_put(p, device)
            if khi is not None:
                khi = jax.device_put(khi, device)
            if phi is not None:
                phi = jax.device_put(phi, device)
        return Relation(key=k, payload=p, key_hi=khi, payload_hi=phi,
                        stats=stats)

    def to_numpy(self):
        n = self.key.shape[0] if self.num_valid is None else int(self.num_valid)
        return np.asarray(self.key)[:n], np.asarray(self.payload)[:n]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JoinResult:
    """Result of a join: match count, and optionally materialized rid pairs.

    The reference counts matches by default (src/main.c:117-123) and
    materializes <R.payload, S.payload> pairs only with
    -DJOIN_RESULT_MATERIALIZE (src/tuple_buffer.h).  Here materialization is a
    runtime option: ``r_payload``/``s_payload`` are capacity-padded columns
    with ``total_results`` valid entries.
    """

    total_results: jax.Array  # scalar count
    s_after_filter: Optional[jax.Array] = None  # S tuples surviving bloom prune
    r_payload: Optional[jax.Array] = None
    s_payload: Optional[jax.Array] = None

    def count(self) -> int:
        return int(self.total_results)
