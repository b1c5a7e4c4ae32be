"""NumPy oracle: full (unbanded) affine-gap pairwise alignment with traceback.

This is the executable *spec* against which the batched/banded device kernels
(ops/banded.py, ops/pallas/*) are differentially tested, and the scalar
reference implementation of the consensus algorithm (SURVEY.md §7.2 step 2).
It replicates the alignment semantics ccsx consumes from bsalign
(kmer_striped_seqedit_pairwise at main.c:264; result fields per
seqalign_result_t, main.c:272-280) without reusing its implementation:
a plain Gotoh affine-gap DP.

Modes
-----
  global : both sequences end-to-end (Needleman-Wunsch/Gotoh).
  qfree  : query prefix/suffix free, template end-to-end — used by
           strand_match-style orientation tests where a longer pass is
           clipped to the template span [qb, qe) (main.c:392-394).
  local  : Smith-Waterman (both-ends-free), closest to the reference's
           seeded pairwise behavior on diverged ends.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

NEG = -(10 ** 9)


@dataclasses.dataclass
class AlnResult:
    """Mirrors the fields ccsx reads from seqalign_result_t (main.c:272-280)."""

    score: int
    qb: int
    qe: int
    tb: int
    te: int
    aln: int          # alignment columns
    mat: int          # exact matches
    mis: int
    ins: int          # query-only bases (gap in template)
    del_: int         # template-only bases (gap in query)
    cigar: List[Tuple[str, int]]  # ops over [qb,qe)x[tb,te), 'M','I','D'

    @property
    def identity(self) -> float:
        return self.mat / self.aln if self.aln else 0.0


def _push(cigar: List[Tuple[str, int]], op: str):
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + 1)
    else:
        cigar.append((op, 1))


def align(
    q: np.ndarray,
    t: np.ndarray,
    mode: str = "global",
    match: int = 2,
    mismatch: int = -6,
    gap_open: int = -3,
    gap_extend: int = -2,
) -> AlnResult:
    """Affine-gap DP; a gap of length L costs gap_open + L*gap_extend."""
    q = np.asarray(q, dtype=np.int32)
    t = np.asarray(t, dtype=np.int32)
    Q, T = len(q), len(t)
    oe = gap_open + gap_extend

    H = np.full((Q + 1, T + 1), NEG, dtype=np.int64)
    E = np.full((Q + 1, T + 1), NEG, dtype=np.int64)  # gap in template (up moves)
    F = np.full((Q + 1, T + 1), NEG, dtype=np.int64)  # gap in query (left moves)

    H[0, 0] = 0
    if mode == "global":
        for i in range(1, Q + 1):
            E[i, 0] = gap_open + i * gap_extend
            H[i, 0] = E[i, 0]
        for j in range(1, T + 1):
            F[0, j] = gap_open + j * gap_extend
            H[0, j] = F[0, j]
    elif mode == "qfree":
        H[1:, 0] = 0
        for j in range(1, T + 1):
            F[0, j] = gap_open + j * gap_extend
            H[0, j] = F[0, j]
    elif mode == "local":
        H[:, 0] = 0
        H[0, :] = 0
    else:
        raise ValueError(mode)

    sub = np.where(q[:, None] == t[None, :], match, mismatch)
    # N (code 4) never matches anything, including itself
    sub[(q >= 4)[:, None] | (t >= 4)[None, :]] = mismatch

    # The row recurrence F[j] = max(H[j-1] + oe, F[j-1] + E) is solved as
    # a prefix max, F[j] = E*(j-1) + oe + max_{j'<j}(H[j'] - E*j'): a gap
    # re-opened from an F cell is dominated when gap_open <= 0 (Gotoh), so
    # H[j'] may be taken without its F term.  Same values as the
    # cell-by-cell loop, one vectorized pass per row.
    jj = np.arange(T + 1, dtype=np.int64)
    for i in range(1, Q + 1):
        Erow = np.maximum(H[i - 1, :] + oe, E[i - 1, :] + gap_extend)
        E[i, :] = Erow
        Hrow = H[i, :]
        hd = np.full(T + 1, NEG, dtype=np.int64)
        hd[1:] = np.maximum(H[i - 1, :-1] + sub[i - 1], Erow[1:])
        if mode == "local":
            hd[1:] = np.maximum(hd[1:], 0)
        hd[0] = Hrow[0]
        hd[1:] = np.maximum(hd[1:], Hrow[1:])
        run = np.maximum.accumulate(hd - gap_extend * jj)
        Frow = F[i, :]
        Frow[1:] = run[:-1] + gap_extend * jj[:-1] + oe
        Hrow[1:] = np.maximum(hd[1:], Frow[1:])

    # --- pick the end cell ---
    if mode == "global":
        ei, ej = Q, T
    elif mode == "qfree":
        ei = int(np.argmax(H[:, T]))
        ej = T
    else:
        ei, ej = np.unravel_index(int(np.argmax(H)), H.shape)
    score = int(H[ei, ej])

    # --- traceback ---
    cigar: List[Tuple[str, int]] = []
    i, j = ei, ej
    state = "H"
    mat = mis = ins = dl = 0
    while True:
        if state == "H":
            if mode == "local" and H[i, j] == 0:
                break
            if mode == "qfree" and j == 0:
                break
            if mode == "global" and i == 0 and j == 0:
                break
            if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                _push(cigar, "M")
                if q[i - 1] == t[j - 1] and q[i - 1] < 4:
                    mat += 1
                else:
                    mis += 1
                i -= 1
                j -= 1
            elif i > 0 and H[i, j] == E[i, j]:
                state = "E"
            elif j > 0 and H[i, j] == F[i, j]:
                state = "F"
            else:  # boundary rows in global mode
                if i > 0:
                    state = "E"
                else:
                    state = "F"
        elif state == "E":
            _push(cigar, "I")
            ins += 1
            if E[i, j] == (E[i - 1, j] + gap_extend) and i > 1:
                i -= 1
            else:
                i -= 1
                state = "H"
        else:  # F
            _push(cigar, "D")
            dl += 1
            if F[i, j] == (F[i, j - 1] + gap_extend) and j > 1:
                j -= 1
            else:
                j -= 1
                state = "H"

    cigar.reverse()
    qb, tb = i, j
    return AlnResult(
        score=score, qb=qb, qe=ei, tb=tb, te=ej,
        aln=mat + mis + ins + dl, mat=mat, mis=mis, ins=ins, del_=dl,
        cigar=cigar,
    )


def strand_match_oracle(q, t, similarity_pct: int, **scores) -> Tuple[bool, AlnResult]:
    """Acceptance rule of strand_match (main.c:280):
    aln*2 > min(qlen, tlen) and mat*100 >= aln*similarity_pct."""
    rs = align(q, t, mode="local", **scores)
    ok = (rs.aln * 2 > min(len(q), len(t))) and (rs.mat * 100 >= rs.aln * similarity_pct)
    return ok, rs


def project_to_template(
    rs: AlnResult, q: np.ndarray, tlen: int, max_ins: int = 4
) -> tuple:
    """Convert a traceback into the star-MSA projection used by consensus.

    Returns (aligned, ins_len, ins_bases, covered):
      aligned[j]  : query code (0-3) aligned to template position j, 4 if the
                    alignment deletes j, 5 if j is outside [tb, te).
      ins_len[j]  : number of query bases inserted AFTER template position j
                    (insertions before tb are credited to slot tb-1; an
                    insertion before template position 0 is dropped).
      ins_bases[j]: first max_ins inserted base codes after j (5-padded).
      covered[j]  : True for tb <= j < te.
    """
    aligned = np.full(tlen, 5, dtype=np.uint8)
    ins_len = np.zeros(tlen, dtype=np.int32)
    ins_bases = np.full((tlen, max_ins), 5, dtype=np.uint8)
    covered = np.zeros(tlen, dtype=bool)
    covered[rs.tb:rs.te] = True

    qi, tj = rs.qb, rs.tb
    for op, ln in rs.cigar:
        if op == "M":
            aligned[tj:tj + ln] = q[qi:qi + ln]
            qi += ln
            tj += ln
        elif op == "D":
            aligned[tj:tj + ln] = 4
            tj += ln
        else:  # I — insertion after template position tj-1
            slot = tj - 1
            if slot >= 0:
                base = ins_len[slot]
                take = min(ln, max(0, max_ins - base))
                if take > 0:
                    ins_bases[slot, base:base + take] = q[qi:qi + take]
                ins_len[slot] += ln
            qi += ln
    return aligned, ins_len, ins_bases, covered
