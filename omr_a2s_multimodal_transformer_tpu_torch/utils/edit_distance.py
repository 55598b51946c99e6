"""Levenshtein distance over token sequences.

Port of ``omr_a2s_multimodal_transformer_tpu/utils/edit_distance.py``:
tokens are interned to int32 and the DP runs in C++ (the native route, the
default: ``csrc/editdist.cpp`` ``levenshtein_i32``, built on first use by
the host's C++ compiler, ``ops/cuda_build.py`` ``host_library``) or a row
at a time in numpy ufuncs (``route="numpy"``, the plain version). A failed
build raises with the compiler's output: no route falls back to another.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

ROUTES = ("native", "numpy")
_I32P = ctypes.POINTER(ctypes.c_int32)


def native_library() -> ctypes.CDLL:
    """``csrc/editdist.cpp`` built and loaded (once), its signatures set."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops.cuda_build import host_library

    lib = host_library("editdist")
    if not getattr(lib, "_signatures_set", False):
        lib.levenshtein_i32.restype = ctypes.c_int64
        lib.levenshtein_i32.argtypes = [_I32P, ctypes.c_int64, _I32P, ctypes.c_int64]
        lib.smith_waterman_i32.restype = ctypes.c_int64
        lib.smith_waterman_i32.argtypes = [
            _I32P, ctypes.c_int64, _I32P, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            _I32P, _I32P, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib._signatures_set = True
    return lib


def _lev_native(a: np.ndarray, b: np.ndarray) -> int:
    return int(native_library().levenshtein_i32(a.ctypes.data_as(_I32P), len(a), b.ctypes.data_as(_I32P), len(b)))


def _intern(a: Sequence, b: Sequence):
    table = {}
    def ids(seq):
        out = np.empty(len(seq), np.int32)
        for i, t in enumerate(seq):
            out[i] = table.setdefault(t, len(table))
        return out
    return ids(a), ids(b)


def _lev_numpy(a: np.ndarray, b: np.ndarray) -> int:
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(n + 1, dtype=np.int32)
    cur = np.empty(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        cur[0] = i
        sub = prev[:-1] + (a != b[i - 1])
        dele = prev[1:] + 1
        np.minimum(sub, dele, out=sub)
        # insertion has a sequential dependency -> running scan
        run = cur[0]
        for j in range(1, n + 1):
            run = min(run + 1, sub[j - 1])
            cur[j] = run
        prev, cur = cur, prev
    return int(prev[n])


def levenshtein(a: Sequence, b: Sequence, route: str = "native") -> int:
    """Edit distance between two token sequences (any hashable tokens), by
    the native route or the numpy one (``ROUTES``)."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    ia, ib = _intern(a, b)
    return _lev_native(ia, ib) if route == "native" else _lev_numpy(ia, ib)


def levenshtein_python(a: Sequence, b: Sequence) -> int:
    """Reference-identical pure-Python DP (for differential testing)."""
    n, m = len(a), len(b)
    if n > m:
        a, b, n, m = b, a, m, n
    current = list(range(n + 1))
    for i in range(1, m + 1):
        previous, current = current, [i] + [0] * n
        for j in range(1, n + 1):
            add, delete = previous[j] + 1, current[j - 1] + 1
            change = previous[j - 1] + (a[j - 1] != b[i - 1])
            current[j] = min(add, delete, change)
    return current[n]
