"""Levenshtein distance over token sequences (numpy).

Port of ``omr_a2s_multimodal_transformer_tpu/utils/edit_distance.py``,
numpy path only: tokens are interned to int32 and the DP runs a row at a
time in numpy ufuncs. The JAX package's optional native route
(``native/libeditdist.so``) is not ported, and ``levenshtein`` never looks
for it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


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


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two token sequences (any hashable tokens)."""
    return _lev_numpy(*_intern(a, b))


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
