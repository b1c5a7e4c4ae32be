"""The traceback walk: a pass's move bytes -> its projection on the
template's columns (NumPy).

From (qlen, tlen) back to (0, 0), cell by cell, following each cell's H
choice and staying in E or F while the move byte says the gap was
extended:

  aligned[j]   the query base aligned to column j, 4 for a deletion
  ins_cnt[j]   query bases inserted after column j
  ins_b[j, r]  the last ``max_ins`` of them, in order, left-justified
  lead_ins     query bases before column 0
"""

from __future__ import annotations

import numpy as np

from h100bench.reference.fill import EBIT_EXT, FBIT_EXT, MOVE_UP

GAP = 4
PAD = 5
_H, _E, _F = 0, 1, 2


def _walk_one(mv, of, q, qlen, tlen, max_ins, aligned, ins_cnt, ins_b):
    qmax, B = mv.shape
    i, j, state = qlen, tlen, _H
    while i > 0 or j > 0:
        row = min(max(i - 1, 0), qmax - 1)
        lane = min(max(j - int(of[row]), 0), B - 1)
        m = int(mv[row, lane])
        if j == 0 and i > 0:
            op = 1
        elif i == 0 and j > 0:
            op = 2
        elif state == _E:
            op = 1
        elif state == _F:
            op = 2
        else:
            choice = m & 3
            op = 0 if choice == 0 else (1 if choice == MOVE_UP else 2)
        if op == 0:
            aligned[j - 1] = q[i - 1]
            i, j, state = i - 1, j - 1, _H
        elif op == 1:
            pos = max_ins - 1 - ins_cnt[j]
            if pos >= 0:
                ins_b[j, pos] = q[i - 1]
            ins_cnt[j] += 1
            state = _E if (m & EBIT_EXT) or j == 0 else _H
            i -= 1
        else:
            aligned[j - 1] = GAP
            state = _F if (m & FBIT_EXT) or i == 0 else _H
            j -= 1


def project(moves: np.ndarray, offs: np.ndarray, qs: np.ndarray,
            qlens: np.ndarray, tlens: np.ndarray, tmax: int,
            max_ins: int = 4):
    """The walk of every pass: (aligned (P, tmax) uint8, ins_cnt (P, tmax)
    int32, ins_b (P, tmax, max_ins) uint8, lead_ins (P,) int32)."""
    P, qmax = moves.shape[:2]
    aligned = np.full((P, tmax), PAD, np.uint8)
    ins_cnt = np.zeros((P, tmax + 1), np.int32)
    ins_b = np.full((P, tmax + 1, max_ins), PAD, np.uint8)
    for p in range(P):
        _walk_one(moves[p], offs[p], qs[p],
                  min(max(int(qlens[p]), 0), qmax),
                  min(max(int(tlens[p]), 0), tmax), max_ins,
                  aligned[p], ins_cnt[p], ins_b[p])
    used = np.minimum(ins_cnt, max_ins)
    cols = np.arange(max_ins)[None, None, :] + (max_ins - used)[:, :, None]
    ins_b = np.take_along_axis(ins_b, np.clip(cols, 0, max_ins - 1), axis=2)
    ins_b = np.where(np.arange(max_ins)[None, None, :] < used[:, :, None],
                     ins_b, PAD).astype(np.uint8)
    return (aligned, np.ascontiguousarray(ins_cnt[:, 1:]),
            np.ascontiguousarray(ins_b[:, 1:]), ins_cnt[:, 0].copy())
