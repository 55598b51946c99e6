"""Smith-Waterman late fusion of image/audio predictions.

Port of ``omr_a2s_multimodal_transformer_tpu/fusion/smith_waterman.py``
(parity target: the reference's ``src/multimodal/smith_waterman/``): the
alignment runs over interned int tokens, affine gaps like swalign's
gap_penalty/gap_extension model, by the native route (the default:
``csrc/editdist.cpp`` ``smith_waterman_i32``, built on first use by the
host's C++ compiler) or the Python Gotoh route (``route="python"``, the
plain version). Both give the same alignment; a failed build raises, and
no route falls back to another.

Fusion policy (reference smith_waterman.py:118-159):
  match    -> keep the token
  mismatch -> keep the higher-probability token (query wins ties)
  gap      -> keep the token that is present
Sequences are bracketed with sentinels (prob 1) before alignment, like the
reference's "¡"/"!", which anchors the local alignment to the full spans.
Tokens outside the locally aligned window are dropped, as in the
reference's dump().
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import ctypes

import numpy as np

from omr_a2s_multimodal_transformer_tpu_torch.utils.edit_distance import native_library

ROUTES = ("native", "python")
_I32P = ctypes.POINTER(ctypes.c_int32)

_SENT_L = "\x00<sw:begin>"
_SENT_R = "\x00<sw:end>"

OP_MATCH, OP_INS, OP_DEL = 0, 1, 2  # I consumes query, D consumes ref


def _sw_python(ref: Sequence[int], query: Sequence[int], match: float, mismatch: float,
               gap_open: float, gap_extend: float) -> Tuple[List[Tuple[int, int]], int, int]:
    """Gotoh local alignment -> (cigar [(op, count)], ref_start, query_start).

    Float64 scores in Python lists (the JAX package keeps them in numpy
    arrays: the same doubles, read faster). On exact ties the diagonal wins
    over E (a gap in the query) and E over F; a cell stops the alignment
    only if every candidate is <= 0."""
    n, m = len(ref), len(query)
    neg = -1e30
    ref, query = [int(t) for t in ref], [int(t) for t in query]
    h = [[0.0] * (n + 1) for _ in range(m + 1)]
    e = [[neg] * (n + 1) for _ in range(m + 1)]
    f = [[neg] * (n + 1) for _ in range(m + 1)]
    tb = [[0] * (n + 1) for _ in range(m + 1)]
    te = [[0] * (n + 1) for _ in range(m + 1)]
    tf = [[0] * (n + 1) for _ in range(m + 1)]
    best, bi, bj = 0.0, 0, 0
    for j in range(1, m + 1):
        h_up, h_row, e_row, f_up, f_row = h[j - 1], h[j], e[j], f[j - 1], f[j]
        tb_row, te_row, tf_row = tb[j], te[j], tf[j]
        qj = query[j - 1]
        for i in range(1, n + 1):
            eo, ee = h_row[i - 1] + gap_open, e_row[i - 1] + gap_extend
            e_row[i] = max(eo, ee)
            te_row[i] = 1 if ee > eo else 0
            fo, fe = h_up[i] + gap_open, f_up[i] + gap_extend
            f_row[i] = max(fo, fe)
            tf_row[i] = 1 if fe > fo else 0
            s = match if ref[i - 1] == qj else mismatch
            v, t = 0.0, 0
            if h_up[i - 1] + s > v:
                v, t = h_up[i - 1] + s, 1
            if e_row[i] > v:
                v, t = e_row[i], 2
            if f_row[i] > v:
                v, t = f_row[i], 3
            h_row[i], tb_row[i] = v, t
            if v > best:
                best, bi, bj = v, i, j
    cigar: List[Tuple[int, int]] = []

    def push(op):
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))

    i, j, state = bi, bj, 0
    while i > 0 and j > 0:
        if state == 0:
            t = tb[j][i]
            if t == 0:
                break
            if t == 1:
                push(OP_MATCH)
                i -= 1
                j -= 1
            else:
                state = t
        elif state == 2:
            push(OP_DEL)
            ext = te[j][i]
            i -= 1
            if not ext:
                state = 0
        else:
            push(OP_INS)
            ext = tf[j][i]
            j -= 1
            if not ext:
                state = 0
    cigar.reverse()
    return cigar, i, j


def _sw_native(ref: np.ndarray, query: np.ndarray, match: float, mismatch: float, gap_open: float,
               gap_extend: float) -> Tuple[List[Tuple[int, int]], int, int]:
    """The same alignment by ``smith_waterman_i32`` (the cigar's capacity,
    n + m + 2 runs, always suffices)."""
    cap = len(ref) + len(query) + 2
    ops, counts = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
    rp, qp = ctypes.c_int64(), ctypes.c_int64()
    k = native_library().smith_waterman_i32(
        ref.ctypes.data_as(_I32P), len(ref), query.ctypes.data_as(_I32P), len(query),
        match, mismatch, gap_open, gap_extend, ops.ctypes.data_as(_I32P), counts.ctypes.data_as(_I32P), cap,
        ctypes.byref(rp), ctypes.byref(qp))
    if k < 0:
        raise RuntimeError(f"smith_waterman_i32: cigar over its capacity {cap}")
    return [(int(ops[x]), int(counts[x])) for x in range(k)], int(rp.value), int(qp.value)


def align_tokens(
    ref_tokens: Sequence[str],
    query_tokens: Sequence[str],
    match: float = 2,
    mismatch: float = -1,
    gap_open: float = -1,
    gap_extend: float = -1,
    route: str = "native",
) -> Tuple[List[Tuple[int, int]], int, int]:
    """Local alignment over token sequences -> (cigar, ref_start, query_start),
    by the native route or the Python one (``ROUTES``)."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    table: Dict[str, int] = {}

    def intern(seq):
        out = np.empty(len(seq), np.int32)
        for i, t in enumerate(seq):
            out[i] = table.setdefault(t, len(table))
        return out

    align = _sw_native if route == "native" else _sw_python
    return align(intern(ref_tokens), intern(query_tokens), float(match), float(mismatch), float(gap_open),
                 float(gap_extend))


def fuse_predictions(
    ref_tokens: List[str],
    ref_probs: List[float],
    query_tokens: List[str],
    query_probs: List[float],
    match: float = 2,
    mismatch: float = -1,
    gap_penalty: float = -1,
    gap_extension_penalty: float = -1,
    route: str = "native",
) -> List[str]:
    """Align two prediction streams and fuse them (reference policy).

    ref = image prediction, query = audio prediction in the reference script
    (smith_waterman/test.py:143-157). Probabilities are per-token scores
    (the reference uses raw top-1 logits). Ties go to the query.
    """
    r = [_SENT_L] + list(ref_tokens) + [_SENT_R]
    q = [_SENT_L] + list(query_tokens) + [_SENT_R]
    rp = [1.0] + list(ref_probs) + [1.0]
    qp = [1.0] + list(query_probs) + [1.0]
    cigar, ri, qi = align_tokens(r, q, match, mismatch, gap_penalty, gap_extension_penalty, route)

    fused: List[str] = []
    for op, count in cigar:
        for _ in range(count):
            if op == OP_MATCH:
                tok_r, tok_q = r[ri], q[qi]
                if tok_r == tok_q:
                    fused.append(tok_q)
                else:  # mismatch: higher prob wins, query wins ties
                    fused.append(tok_q if qp[qi] >= rp[ri] else tok_r)
                ri += 1
                qi += 1
            elif op == OP_DEL:  # token only in ref
                fused.append(r[ri])
                ri += 1
            else:  # OP_INS: token only in query
                fused.append(q[qi])
                qi += 1
    return [t for t in fused if t not in (_SENT_L, _SENT_R)]
