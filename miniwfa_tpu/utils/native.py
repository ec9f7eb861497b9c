"""ctypes bridge to the native C++ runtime kernels (libmwfrt.so).

The hot device work is all JAX/XLA; these native kernels cover the
host-side sequential decoders that are O(n+s) pointer chases — too serial
for the device, too slow in pure Python at 5 Mb scale: the traceback walker,
the LIS inner loop, and the checkpoint chain decode (SURVEY.md §2 C10/C13/
C15 → "native component" mapping).

The library is built from native/mwfrt.cpp by `make -C native` (or
lazily on first use if a compiler is available).  Every entry point has a
pure-Python fallback, so the framework works without it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
_LOCK = threading.Lock()

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO = os.path.join(_ROOT, "native", "libmwfrt.so")
_SRC = os.path.join(_ROOT, "native", "mwfrt.cpp")


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", _SO, _SRC],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        stale = os.path.exists(_SO) and os.path.exists(_SRC) and \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        if (not os.path.exists(_SO) or stale) and not _build() \
                and not os.path.exists(_SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.mwf_lis_u64.restype = ctypes.c_int64
        lib.mwf_lis_u64.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64)]
        try:
            lib.mwf_kmer_codes.restype = ctypes.c_int64
            lib.mwf_kmer_codes.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64)]
            lib.mwf_match_pairs.restype = ctypes.c_int64
            lib.mwf_match_pairs.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,   # ts, tn
                ctypes.c_char_p, ctypes.c_int64,   # qs, qn
                ctypes.c_int32, ctypes.c_int32,    # k, max_occ
                ctypes.POINTER(ctypes.c_uint64),   # scratch [2*(tn+qn)]
                ctypes.POINTER(ctypes.c_uint64),   # out [cap]
                ctypes.c_int64]                    # cap
            _HAS_KMER = True
        except AttributeError:
            _HAS_KMER = False   # stale .so without the k-mer entry points
        lib._mwf_has_kmer = _HAS_KMER
        lib.mwf_traceback.restype = ctypes.c_int64
        lib.mwf_traceback.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),   # tb_bits [n_rows, W]
            ctypes.c_int64,                   # W
            ctypes.POINTER(ctypes.c_int32),   # tb_lo [n_rows]
            ctypes.c_int32,                   # m1
            ctypes.c_char_p, ctypes.c_int64,  # ts, tl
            ctypes.c_char_p, ctypes.c_int64,  # qs, ql
            ctypes.c_int32,                   # s_final
            ctypes.c_int32,                   # last_state
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # x, o1, e1
            ctypes.c_int32, ctypes.c_int32,                  # o2, e2
            ctypes.POINTER(ctypes.c_uint32),  # out cigar buffer
            ctypes.c_int64]                   # out capacity
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def has_kmer() -> bool:
    lib = _load()
    return lib is not None and getattr(lib, "_mwf_has_kmer", False)


def kmer_codes(seq: bytes, rid: int, k: int) -> np.ndarray:
    """(kmer<<1|rid)<<32|end_pos codes (reference mg_fc_kmer semantics)."""
    lib = _load()
    assert lib is not None
    out = np.empty(max(len(seq), 1), dtype=np.uint64)
    n = lib.mwf_kmer_codes(
        seq, len(seq), rid, k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out[:n]


def match_pairs_u64(ts: bytes, qs: bytes, k: int, max_occ: int) -> np.ndarray:
    """Sorted pos_t<<32|pos_q match pairs (reference mg_chain first half)."""
    lib = _load()
    assert lib is not None
    nn = len(ts) + len(qs)
    scratch = np.empty(max(2 * nn, 2), dtype=np.uint64)
    cap = max(max_occ * max_occ * nn // 2 + 16, 2 * nn + 16)
    out = np.empty(cap, dtype=np.uint64)
    m = lib.mwf_match_pairs(
        ts, len(ts), qs, len(qs), k, max_occ,
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), cap)
    if m < 0:
        raise RuntimeError("mwf_match_pairs output capacity exceeded")
    return out[:m].copy()


def lis_u64(a: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    a = np.ascontiguousarray(a, dtype=np.uint64)
    out = np.zeros(a.size, dtype=np.int64)
    n = lib.mwf_lis_u64(
        a.size, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out[:n]


def traceback(tb_bits: np.ndarray, tb_lo: np.ndarray, m1: int,
              ts: bytes, qs: bytes, s_final: int, last_state: int,
              x: int, o1: int, e1: int, o2: int, e2: int):
    """Returns packed CIGAR array, or None if the native walker is absent."""
    lib = _load()
    if lib is None:
        return None
    tb_bits = np.ascontiguousarray(tb_bits, dtype=np.uint8)
    tb_lo = np.ascontiguousarray(tb_lo, dtype=np.int32)
    cap = len(ts) + len(qs) + 16
    out = np.zeros(cap, dtype=np.uint32)
    w = tb_bits.shape[1] if tb_bits.ndim == 2 else 0
    n = lib.mwf_traceback(
        tb_bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w,
        tb_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), m1,
        ts, len(ts), qs, len(qs), s_final, last_state,
        x, o1, e1, o2, e2,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
    if n < 0:
        return None
    return out[:n]
