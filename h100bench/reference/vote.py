"""The column vote over a window's passes, and the consensus it spells
(NumPy).

A column's call is the most frequent of the five classes (four bases and
the gap) among the passes that cover it, the lowest code on ties; rank r of
the insertions after a column counts the passes that inserted at least
r + 1 bases there, and their most frequent base.  A strict round emits an
insertion rank where a majority of the covering passes voted for it; a
speculative round also where at least max(2, ceil(n / 3)) did; rank r only
if rank r - 1 was emitted.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GAP = 4
PAD = 5


@dataclasses.dataclass
class Round:
    cons: np.ndarray       # (T,) uint8
    ins_base: np.ndarray   # (T, R) uint8
    ins_votes: np.ndarray  # (T, R) int32
    ncov: np.ndarray       # (T,) int32
    match: np.ndarray      # (P, T) bool
    aligned: np.ndarray    # (P, T) uint8
    ins_cnt: np.ndarray    # (P, T) int32
    lead_ins: np.ndarray   # (P,) int32
    tlen: int

    def materialize(self, upto=None, speculative=False) -> np.ndarray:
        n = self.tlen if upto is None else upto
        return materialize(self.cons, emit_insertions(
            self.ins_base, self.ins_votes, self.ncov, speculative), n)


def vote(aligned, ins_cnt, ins_b, row_mask, max_ins, tlen) -> Round:
    """The vote of one window's passes (rows), over their first tlen
    columns; a row outside ``row_mask`` (an empty window) counts nothing
    and matches nothing."""
    aligned = aligned[:, :tlen]
    ins_cnt = ins_cnt[:, :tlen]
    ins_b = ins_b[:, :tlen]
    mask = np.asarray(row_mask, bool)[:, None]
    cnts = np.stack([((aligned == c) & mask).sum(0, dtype=np.int32)
                     for c in range(5)])
    ncov = cnts.sum(0, dtype=np.int32)
    cons = np.argmax(cnts, axis=0).astype(np.uint8)
    cons = np.where(ncov == 0, GAP, cons).astype(np.uint8)
    bases, votes = [], []
    for r in range(max_ins):
        has = mask & (ins_cnt > r)
        votes.append(has.sum(0, dtype=np.int32))
        bc = np.stack([((ins_b[..., r] == c) & has).sum(0, dtype=np.int32)
                       for c in range(4)])
        bases.append(np.argmax(bc, axis=0).astype(np.uint8))
    match = (aligned == cons[None, :]) & mask
    return Round(cons=cons, ins_base=np.stack(bases, axis=-1),
                 ins_votes=np.stack(votes, axis=-1), ncov=ncov, match=match,
                 aligned=aligned, ins_cnt=ins_cnt, lead_ins=None, tlen=tlen)


def emit_insertions(ins_base, ins_votes, ncov, speculative):
    ins_votes = ins_votes.astype(np.int32)
    n = ncov.astype(np.int32)[:, None]
    emit = ins_votes * 2 > n
    if speculative:
        emit |= ins_votes >= np.maximum(2, -(-n // 3))
    emit = np.logical_and.accumulate(emit, axis=1)
    return np.where(emit, ins_base, PAD).astype(np.uint8)


def materialize(cons, ins_out, tlen) -> np.ndarray:
    m = np.concatenate([cons[:tlen, None], ins_out[:tlen]], axis=1).ravel()
    return m[m < 4].astype(np.uint8)
