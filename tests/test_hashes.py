"""Hash library bit-exactness vs golden vectors from the reference binary.

Fixture tests/fixtures/hash_golden.npz was produced by a one-off C driver
linking the reference's src/hash.c + src/spooky.c (8 seeds x 64 keys per
function, including edge keys 0, -1, INT_MIN, INT_MAX and bytes >= 0x80 that
exercise the signed-char mixing semantics).
"""

import os

import numpy as np
import pytest

from hwbloomradixjoin.ops import hashes

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hash_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.mark.parametrize("name", sorted(hashes.HASH_FUNCTIONS))
def test_hash_matches_reference(golden, name):
    fn = hashes.HASH_FUNCTIONS[name]
    seeds = golden[name + "_seed"]
    keys = golden[name + "_key"]
    want = golden[name + "_hash"]
    # vectorize over all (seed, key) pairs at once
    got = np.asarray(fn(seeds.astype(np.uint32), keys.view(np.uint32)))
    mism = np.nonzero(got != want)[0]
    assert mism.size == 0, (
        f"{name}: {mism.size}/{len(want)} mismatches, first at seed={seeds[mism[0]]} "
        f"key={keys[mism[0]]}: got {got[mism[0]]:#x} want {want[mism[0]]:#x}"
    )


def test_hash_shapes_and_dtype():
    k = np.arange(1024, dtype=np.uint32).reshape(8, 128)
    for name, fn in hashes.HASH_FUNCTIONS.items():
        out = np.asarray(fn(np.uint32(42), k))
        assert out.shape == (8, 128), name
        assert out.dtype == np.uint32, name
