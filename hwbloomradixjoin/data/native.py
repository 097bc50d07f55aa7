"""ctypes bindings to the native host runtime (native/libhbrj_native.so).

The native library provides glibc-rand()-compatible streams and the
rand()-driven generators (Zipf, non-unique, shuffles) plus scalar ground-truth
validators.  It is not committed: the first use builds it from
native/hbrj_native.cpp with `make` (g++, std::thread), and later uses load
it.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libhbrj_native.so")

_lock = threading.Lock()
_lib = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def _stale() -> bool:
    return not os.path.exists(_SO_PATH) or (
        os.path.getmtime(_SO_PATH)
        < os.path.getmtime(os.path.join(_NATIVE_DIR, "hbrj_native.cpp")))


def _build():
    """Build the library once across concurrent processes (test workers):
    an exclusive lock on the source serializes builders, and the library
    appears by atomic rename, so no process loads a half-written file."""
    with open(os.path.join(_NATIVE_DIR, "hbrj_native.cpp")) as src:
        fcntl.flock(src, fcntl.LOCK_EX)
        if _stale():
            tmp = _SO_PATH + ".tmp"
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s", "-B",
                            f"TARGET={os.path.basename(tmp)}"], check=True)
            os.replace(tmp, _SO_PATH)


def lib() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        L = ctypes.CDLL(_SO_PATH)
        L.hbrj_srand.argtypes = [ctypes.c_uint32]
        L.hbrj_rand.restype = ctypes.c_int32
        L.hbrj_rand_stream.argtypes = [ctypes.c_uint32, ctypes.c_int64, _i32p]
        L.hbrj_gen_zipf.argtypes = [
            ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, _i32p]
        L.hbrj_random_gen.argtypes = [
            ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p]
        L.hbrj_knuth_shuffle.argtypes = [
            ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64, _i32p]
        L.hbrj_nonunique_from_pk.argtypes = [
            ctypes.c_uint32, _i32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, _i32p]
        L.hbrj_fk_from_pk.argtypes = [
            ctypes.c_uint32, _i32p, _i32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, _i32p, _i32p]
        L.hbrj_ref_join.argtypes = [
            _i32p, _i32p, ctypes.c_int64, _i32p, _i32p, ctypes.c_int64, _u64p]
        L.hbrj_ref_bloom.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint32, _i32p, ctypes.c_int64, _i32p, ctypes.c_int64,
            _u8p, ctypes.c_void_p]
        L.hbrj_unique_gen_range.argtypes = [
            ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, _i32p]
        L.hbrj_unique_gen_range.restype = ctypes.c_int64
        _lib = L
        return _lib


def rand_stream(seed: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int32)
    lib().hbrj_rand_stream(seed & 0xFFFFFFFF, n, out)
    return out


def gen_zipf(seed: int, stream_size: int, alphabet_size: int,
             zipf_factor: float) -> np.ndarray:
    out = np.empty(stream_size, dtype=np.int32)
    lib().hbrj_gen_zipf(seed & 0xFFFFFFFF, stream_size, alphabet_size,
                        zipf_factor, out)
    return out


def random_gen(seed: int, n: int, minid: int, maxid: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int32)
    lib().hbrj_random_gen(seed & 0xFFFFFFFF, n, minid, maxid, out)
    return out


def nonunique_from_pk(seed: int, pk_keys: np.ndarray, n: int, threshold: int,
                      selectivity: float) -> np.ndarray:
    out = np.empty(n, dtype=np.int32)
    pk = np.ascontiguousarray(pk_keys, dtype=np.int32)
    lib().hbrj_nonunique_from_pk(seed & 0xFFFFFFFF, pk, len(pk), n, threshold,
                                 selectivity, out)
    return out


def fk_from_pk(seed: int, pk_keys: np.ndarray, pk_pays: np.ndarray, n: int,
               threshold: int, selectivity: float):
    ok = np.empty(n, dtype=np.int32)
    op = np.empty(n, dtype=np.int32)
    pk = np.ascontiguousarray(pk_keys, dtype=np.int32)
    pp = np.ascontiguousarray(pk_pays, dtype=np.int32)
    lib().hbrj_fk_from_pk(seed & 0xFFFFFFFF, pk, pp, len(pk), n, threshold,
                          selectivity, ok, op)
    return ok, op


def ref_join(r_keys, r_pay, s_keys, s_pay):
    """Ground-truth join: (count, sum of matched R payloads, sum of matched S payloads)."""
    out = np.zeros(3, dtype=np.uint64)
    rk = np.ascontiguousarray(r_keys, np.int32)
    sk = np.ascontiguousarray(s_keys, np.int32)
    rp = np.ascontiguousarray(r_pay, np.int32)
    sp = np.ascontiguousarray(s_pay, np.int32)
    lib().hbrj_ref_join(rk, rp, len(rk), sk, sp, len(sk), out)
    return int(out[0]), int(out[1]), int(out[2])


def ref_bloom(variant: str, m: int, k: int, B: int, seed: int,
              add_keys, query_keys, want_bitmap: bool = False):
    """Ground-truth bloom filter: contains-mask for queries (+ bitmap)."""
    v = {"basic": 0, "blocked": 1}[variant]
    ak = np.ascontiguousarray(add_keys, np.int32)
    qk = np.ascontiguousarray(query_keys, np.int32)
    out = np.empty(len(qk), dtype=np.uint8)
    bitmap = np.zeros(m // 8, dtype=np.uint8) if want_bitmap else None
    bm_ptr = bitmap.ctypes.data_as(ctypes.c_void_p) if want_bitmap else None
    lib().hbrj_ref_bloom(v, m, k, B, seed & 0xFFFFFFFF, ak, len(ak),
                         qk, len(qk), out, bm_ptr)
    return (out.astype(bool), bitmap) if want_bitmap else out.astype(bool)


def unique_gen_range(seed: int, skip: int, n: int, minv: int, maxv: int):
    """Selection-sampled unique keys in [minv, maxv); returns (keys, draws_consumed)."""
    out = np.empty(n, dtype=np.int32)
    consumed = lib().hbrj_unique_gen_range(seed & 0xFFFFFFFF, skip, n,
                                           minv, maxv, out)
    return out, int(consumed)
