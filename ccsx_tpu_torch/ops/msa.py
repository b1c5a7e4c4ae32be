"""Star-MSA column voting: consensus call over stacked projections.

The vote is a reduction over the pass axis in plain tensor ops, on whatever
device the projections live.  ``emit_insertions`` and ``materialize`` stay
on the host in NumPy: their output length depends on the data.
"""

from __future__ import annotations

import numpy as np
import torch

GAP = 4
PAD = 5


def vote(aligned: torch.Tensor, ins_cnt: torch.Tensor, ins_b: torch.Tensor,
         row_mask: torch.Tensor, max_ins: int = 4):
    """Column vote.  Shapes: aligned (P, T) uint8, ins_cnt (P, T) int32,
    ins_b (P, T, R) uint8, row_mask (P,) bool.  Returns:
      cons      (T,) uint8  — 0-3 base, 4 gap (column dropped)
      ins_base  (T, R) uint8 — majority inserted base per slot/rank
      ins_votes (T, R) int32 — passes inserting at least r+1 bases at the slot
      ncov      (T,) int32  — covering passes per column
      match     (P, T) bool — pass agrees with the consensus at the column
      nwin      (T,) int32  — passes voting the winning cell
    Ties go to the lowest code (torch.argmax returns the first maximum).
    """
    mask = row_mask[:, None]
    cnts = torch.stack(
        [((aligned == c) & mask).sum(0, dtype=torch.int32) for c in range(5)])
    ncov = cnts.sum(0, dtype=torch.int32)
    nwin = cnts.max(0).values
    cons = torch.argmax(cnts, dim=0).to(torch.uint8)
    cons = torch.where(ncov == 0, GAP, cons).to(torch.uint8)

    bases, votes = [], []
    for r in range(max_ins):
        has = mask & (ins_cnt > r)
        votes.append(has.sum(0, dtype=torch.int32))
        bc = torch.stack([((ins_b[:, :, r] == c) & has).sum(0, dtype=torch.int32)
                          for c in range(4)])
        bases.append(torch.argmax(bc, dim=0).to(torch.uint8))
    ins_base = torch.stack(bases, dim=1)
    ins_votes = torch.stack(votes, dim=1)
    match = (aligned == cons[None, :]) & mask
    return cons, ins_base, ins_votes, ncov, match, nwin


def emit_insertions(ins_base: np.ndarray, ins_votes: np.ndarray,
                    ncov: np.ndarray, speculative: bool) -> np.ndarray:
    """Decide which insertion cells become columns (host, NumPy).

    Strict: a majority of covering passes insert at the slot.  Speculative
    (intermediate refinement rounds): also accept >=2-pass / >=1/3 support,
    so a base the draft is missing becomes a column whose vote next round
    does not split; wrong speculations are deleted by majority gap.
    """
    ins_base = np.asarray(ins_base)
    # widen before arithmetic: votes/coverage may arrive as uint8, and
    # *2 / //3 must not wrap
    ins_votes = np.asarray(ins_votes).astype(np.int32, copy=False)
    n = np.asarray(ncov).astype(np.int32, copy=False)[:, None]
    emit = ins_votes * 2 > n
    if speculative:
        emit |= ins_votes >= np.maximum(2, -(-n // 3))
    # prefix rule: rank r only emits if rank r-1 did
    emit = np.logical_and.accumulate(emit, axis=1)
    return np.where(emit, ins_base, PAD).astype(np.uint8)


def materialize(cons: np.ndarray, ins_out: np.ndarray, tlen: int) -> np.ndarray:
    """Interleave base + insertion columns into the consensus sequence:
    column j's base (if not gap), then the insertions after column j."""
    cons = np.asarray(cons)[:tlen]
    ins = np.asarray(ins_out)[:tlen]
    m = np.concatenate([cons[:, None], ins], axis=1).ravel()
    return m[m < 4].astype(np.uint8)
